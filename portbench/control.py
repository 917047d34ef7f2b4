"""The control of `correct`: runs a cell with the lower precision in the
program's place and prints, for each seed, the numbers the judge compares
beside their limits. A sound limit lies below every reading of the control.

    python3 -m portbench.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]
        [--what program_tf32|reference_tf32|half_batch|first_hypothesis]

`program_tf32` (default): the program itself with TF32 on for cuDNN and
cuBLAS, its own path below the configuration's float32 (PyTorch's default
where the caller does not turn TF32 off), at the cell's own size and load
for a short window, judged as a benchmark run is. `reference_tf32`: the
plain reference with its convolution and matching operands rounded to TF32
(`portbench.reference.nets.round_tf32`) in the program's place, on the
pairs or steps a run judges. `half_batch` (training cells): a fault, not
the control: the program's step on the first half of each batch's pairs
alone, the mean taken over them, judged as a benchmark run is; its readings
bound the training numbers from above. `first_hypothesis` (alignment
cells): a fault, the program's fit returning its first hypothesis with that
hypothesis's own count instead of the best; its readings bound
`ransac_best_gap` from above. The benchmark's own runs never run these.
"""

import argparse
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

from portbench.drivers.base import CONTROL_PRECISION
from portbench.run import ROOT, cell_of, load_json


def control_session(bench, workload, seed, what):
    cell = cell_of(bench, workload)
    cfg = load_json(ROOT / "configs" / f"{cell['config']}.json")
    mix = load_json(ROOT / "traffic" / f"{cell['traffic']}.json")
    if what == "program_tf32":
        cfg = {**cfg, "precision": CONTROL_PRECISION}
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    return driver.Session(cfg, mix, seed, "cuda")


def half_batch_fault():
    """Patches the program's training step to leave out the second half of
    each batch's pairs (the mean taken over the rest). Returns the undo."""
    from ransacflow_tpu_torch.train import trainer

    orig = trainer.train_step

    def step(nets, opt, images, index_roll, grid, mask_margin, **kw):
        b = images.shape[0] // 2
        h = b // 2
        kept = torch.cat([images[:h], images[b:b + h]])
        return orig(nets, opt, kept, trainer.local_index_roll(h, images.device), grid,
                    mask_margin[:2 * h], **kw)

    trainer.train_step = step
    return lambda: setattr(trainer, "train_step", orig)


def first_hypothesis_fault():
    """Patches the program's fit to draw and score one hypothesis a pair:
    the first wins, with its honest count. Returns the undo."""
    from ransacflow_tpu_torch.pipeline import fused

    orig = fused._ransac_batch

    def fit(m1, m2, valid, gens, tolerance, n_iter, adaptive_chunk, draws):
        return orig(m1, m2, valid, gens, tolerance, 1, adaptive_chunk, draws)

    fused._ransac_batch = fit
    return lambda: setattr(fused, "_ransac_batch", orig)


FAULTS = {"half_batch": half_batch_fault, "first_hypothesis": first_hypothesis_fault}


def reference_readings(session):
    """The judge's numbers with the TF32 reference in the program's place."""
    from portbench.drivers import align, train
    from portbench.judges import align as judge_align
    from portbench.judges import train as judge_train
    from portbench.reference import align as ref_align
    from portbench.reference import train as ref_train

    if isinstance(session, train.Session):
        s = session.cfg["settings"]
        params = session.make_weights()
        batches = session.make_batches()[:int(session.mix["checked_steps"])]
        losses, grads, changes = ref_train.run_steps(params, batches, s, mm="tf32")
        checked = {"losses": losses, "first_grads": grads, "changes": changes}
        return judge_train.judge(session.cfg, params, batches, checked)
    assert isinstance(session, align.Session)
    c = session.cfg["settings"]
    trunk, fine = session.make_weights()
    src, tgt = session.make_inputs()
    rng = np.random.default_rng([session.seed, 2])
    rows = rng.choice(src.shape[0], size=int(session.mix["judge_pairs"]), replace=False)
    gen = session.generator("control")
    items = []
    with torch.no_grad():
        for r in sorted(rows.tolist()):
            out = ref_align.align_pair(trunk, fine, src[r:r + 1], tgt[r:r + 1], session.shapes,
                                       c["tolerance"], c["n_hypotheses"], gen,
                                       c["kernel_size"], mm="tf32")
            out = ref_align.to_numpy(out)
            out["flow"], out["flow_down8"] = out["flow"][None], out["flow_down8"][None]
            out["match_down8"] = out["match_down8"][None]
            items.append((src[r:r + 1], tgt[r:r + 1], out))
    return judge_align.judge(session.cfg, session.shapes, trunk, fine, items, session,
                             session.generator("judge"))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--what", choices=("program_tf32", "reference_tf32", *FAULTS),
                   default="program_tf32")
    args = p.parse_args(argv)
    bench = load_json(Path.cwd() / "BENCHMARK.json")
    for seed in args.seeds:
        session = control_session(bench, args.workload, seed, args.what)
        if args.what != "reference_tf32":
            undo = FAULTS[args.what]() if args.what in FAULTS else (lambda: None)
            try:
                session.measure(args.seconds)
            finally:
                undo()
            checks = session.judge()
        else:
            checks = reference_readings(session)
        line = {"workload": args.workload, "what": args.what, "seed": seed,
                "checks": {c["name"]: {"value": c["value"], "limit": c["limit"]}
                           for c in checks},
                "fails": [c["name"] for c in checks if c["value"] > c["limit"]]}
        print(json.dumps(line), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
