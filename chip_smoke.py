#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of the serving path once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass:
  (a) card: a CUDA device is present; prints its name and power limit;
  (b) build: compiles the kernels from `ransacflow_tpu_torch/csrc/`;
  (c) kernels: each hand-written kernel against its plain PyTorch version
      at the serving shapes, with max error and times (CUDA events);
  (d) main path: `fused_align_batch` over 4 pairs at full width (480x640
      targets, 7-scale pyramid from 960x1280, 10k RANSAC hypotheses, fp32,
      seeded weights), checked for finite outputs, against the plain CPU path
      on a small pair, and for a launch of every kernel; prints pairs/s.

Its last three lines are the card (nvidia-smi name, power limit), a JSON
object with the kernels' numbers, and `{"ok": true, "device": {...}}`. It
exits non-zero, without that last line, on any failure or without CUDA.
"""

import json
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

N_PAIRS = 4
N_ITER = 10000
TARGET_HW = (480, 640)
CORR_SHAPE = (1, 60, 80, 256)
N_BANK, N_TARGET, N_CHANNELS = 13065, 1200, 1024


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps=20, warmup=3):
    """Mean milliseconds of fn() over `reps` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(kernel_fn, plain_fn):
    """(kernel ms, plain ms), measured in turns: kernel, plain, plain, kernel."""
    k1, p1, p2, k2 = (cuda_ms(f) for f in (kernel_fn, plain_fn, plain_fn, kernel_fn))
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_card():
    require(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"(a) card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
          flush=True)
    return card


def phase_build():
    from ransacflow_tpu_torch.kernels import build

    build.library()
    regs = [ln.strip() for ln in build.BUILD_LOG["ptxas"].splitlines()
            if "registers" in ln]
    print(f"(b) build: {build.BUILD_LOG['seconds']:.1f} s "
          f"(compiled: {build.BUILD_LOG['built']}); ptxas: {regs}", flush=True)


def _normalized(shape, dim, gen):
    x = torch.randn(shape, generator=gen, device="cuda")
    return x / x.norm(dim=dim, keepdim=True)


def check_correlation(gen):
    from ransacflow_tpu_torch.kernels.correlation import (
        correlation_volume, correlation_volume_ref)

    x = _normalized(CORR_SHAPE, -1, gen)
    y = _normalized(CORR_SHAPE, -1, gen)
    err = 0.0
    for a, b in ((x, y), (y, x)):  # corr12 and corr21
        got = correlation_volume(a, b, 7)
        torch.cuda.synchronize()
        err = max(err, (got - correlation_volume_ref(a, b, 7)).abs().max().item())
    # fp32 sums of 256 products of unit-norm vectors, in another order
    require(err <= 1e-4, f"correlation: max abs err {err} > 1e-4")
    ms, plain_ms = paired_ms(lambda: correlation_volume(x, y, 7),
                             lambda: correlation_volume_ref(x, y, 7))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_matching(gen):
    from ransacflow_tpu_torch.kernels.matching import mutual_argmax, mutual_argmax_ref

    feat_a = _normalized((N_CHANNELS, N_BANK), 0, gen)
    feat_b = _normalized((N_CHANNELS, N_TARGET), 0, gen)
    feat_a[:, 101] = feat_a[:, 57]  # bank rows 57 and 101 tie exactly ...
    feat_b[:, 5] = feat_a[:, 57]    # ... as the best source of target 5
    valid_b = torch.rand(N_TARGET, generator=gen, device="cuda") > 0.1
    valid_b[5] = True
    score = (feat_a.T @ feat_b) * valid_b.float()[None, :]
    require(score[57, 5].item() == score[101, 5].item(), "planted tie is not exact")
    got = mutual_argmax(score)
    want = mutual_argmax_ref(score)
    torch.cuda.synchronize()
    for name, g, w in zip(("best_src", "best_tgt", "valid"), got[:3], want[:3]):
        require(torch.equal(g, w), f"matching: {name} differs from the plain version")
    require(got[0][5].item() == 57, "matching: the tie did not go to the lowest index")
    require(not got[2][~valid_b].any().item(), "matching: a masked target matched")
    err = (got[3] - want[3]).abs().max().item()
    ms, plain_ms = paired_ms(lambda: mutual_argmax(score),
                             lambda: mutual_argmax_ref(score))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_ransac(gen):
    from ransacflow_tpu_torch.kernels.ransac import ransac_score, ransac_score_ref
    from ransacflow_tpu_torch.ops.grid import feature_cell_coords
    from ransacflow_tpu_torch.ops.homography import apply_homography
    from ransacflow_tpu_torch.ops.ransac import sample_minimal_sets

    # 1200 target cells (30 x 40), 60% inliers of a known homography
    y, x = feature_cell_coords(30, 40, "cuda")
    m2 = torch.stack([x, y, torch.ones_like(x)], dim=1)
    h_true = torch.tensor([[1.05, 0.02, 0.03], [-0.01, 0.97, -0.02],
                           [0.02, -0.03, 1.0]], device="cuda")
    m1 = apply_homography(h_true, m2[:, :2])
    m1 = m1 + 0.005 * torch.randn(m1.shape, generator=gen, device="cuda")
    outlier = torch.rand(N_TARGET, generator=gen, device="cuda") > 0.6
    m1[outlier] = torch.rand((int(outlier.sum()), 2), generator=gen, device="cuda") * 2 - 1
    m1 = torch.cat([m1, torch.ones_like(m1[:, :1])], dim=1).contiguous()
    valid = torch.rand(N_TARGET, generator=gen, device="cuda") > 0.1
    samples = sample_minimal_sets(valid, N_ITER, gen)

    H_k, c_k = ransac_score(m1, m2, valid, samples, 0.05)
    H_r, c_r = ransac_score_ref(m1, m2, valid, samples, 0.05)
    torch.cuda.synchronize()
    agree = (c_k == c_r).float().mean().item()
    # fp32 solves in another order of operations: a match on the tolerance
    # boundary may flip, so counts must agree on >= 99.9% of hypotheses
    require(agree >= 0.999, f"ransac: counts agree on only {agree:.5f}")
    require(c_k.max().item() == c_r.max().item(), "ransac: winning counts differ")
    best_k, best_r = int(torch.argmax(c_k)), int(torch.argmax(c_r))
    err = (H_k[best_k] - H_r[best_k]).abs().max().item()
    if best_k == best_r:
        require(err <= 1e-4, f"ransac: winner H21 max abs err {err} > 1e-4")
    require(c_k.max().item() > 0.4 * N_TARGET, "ransac: no good model found")
    ms, plain_ms = paired_ms(lambda: ransac_score(m1, m2, valid, samples, 0.05),
                             lambda: ransac_score_ref(m1, m2, valid, samples, 0.05))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "counts_agree": agree}


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {"correlation_volume": check_correlation(gen),
               "mutual_argmax": check_matching(gen),
               "ransac_score": check_ransac(gen)}
    for name, r in results.items():
        print(f"(c) {name}: " + ", ".join(f"{k}={v}" for k, v in r.items()), flush=True)
    return results


def _blocky(rng, n, h, w):
    base = (rng.rand(n, h // 4, w // 4, 3) > 0.5).astype(np.float32)
    return np.kron(base, np.ones((1, 4, 4, 1), np.float32))[:, :h, :w]


def _nets(device):
    from ransacflow_tpu_torch.models.convert import init_resnet50_layer3
    from ransacflow_tpu_torch.pipeline import init_alignment_params

    return (init_resnet50_layer3(torch.Generator().manual_seed(0), device),
            init_alignment_params(torch.Generator().manual_seed(1), device))


def check_small_pair_against_cpu():
    """The port on the card against its plain CPU path (held against the JAX
    package by tests/test_torch_pipeline.py), one 64x64 pair, same draws."""
    from ransacflow_tpu_torch.pipeline.fused import device_pyramid, fused_align

    rng = np.random.RandomState(3)
    src = torch.from_numpy(_blocky(rng, 1, 128, 128))
    tgt = torch.from_numpy(_blocky(rng, 1, 64, 64))
    samples = torch.from_numpy(rng.randint(0, 16, (256, 4)).astype(np.int32))
    outs = {}
    for device in ("cpu", "cuda"):
        resnet, align = _nets(device)
        pyr = device_pyramid(src.to(device), [(128, 128), (64, 64), (32, 32)])
        outs[device] = fused_align(resnet, align, pyr, tgt.to(device), n_iter=256,
                                   injected_samples=samples.to(device))
    cpu, gpu = outs["cpu"], {k: v.cpu() for k, v in outs["cuda"].items()}
    require(bool(gpu["found"] == cpu["found"]), "small pair: found differs from CPU")
    require(int(gpu["num_inliers"]) == int(cpu["num_inliers"]),
            f"small pair: num_inliers {int(gpu['num_inliers'])} vs CPU "
            f"{int(cpu['num_inliers'])}")
    # The in-bounds mask is a step at |flow| = 1, and the warped grid lands
    # exactly on the border there: a 1e-7 difference flips such a pixel, so
    # matchability is compared off the border.
    border = ((cpu["flow"].abs() - 1).abs() < 1e-5).any(dim=-1)[0]
    errs = {k: (gpu[k].float() - cpu[k].float()).abs().max().item()
            for k in ("H21", "flow")}
    errs["match"] = (gpu["match"] - cpu["match"])[~border].abs().max().item()
    errs["border_px"] = int(border.sum())
    # cuDNN and CPU convolutions sum in other orders (fp32, TF32 off)
    require(errs["H21"] <= 1e-4 and errs["flow"] <= 1e-3 and errs["match"] <= 1e-3,
            f"small pair: differs from CPU: {errs}")
    return errs


def phase_main_path(card):
    from ransacflow_tpu_torch import kernels
    from ransacflow_tpu_torch.pipeline.fused import device_pyramid, fused_align_batch
    from ransacflow_tpu_torch.utils.image import pyramid_shapes

    small = check_small_pair_against_cpu()
    print(f"(d) small pair, card vs CPU max abs err: {small}", flush=True)

    shapes = pyramid_shapes()
    rng = np.random.RandomState(0)
    sources = torch.from_numpy(_blocky(rng, N_PAIRS, *shapes[0])).cuda()
    targets = torch.from_numpy(_blocky(rng, N_PAIRS, *TARGET_HW)).cuda()[:, None]
    resnet, align = _nets("cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)

    def serve():
        pyramids = tuple(p[:, None] for p in device_pyramid(sources, shapes))
        return fused_align_batch(resnet, align, pyramids, targets, gen,
                                 n_iter=N_ITER)

    kernels.reset_launch_counts()
    out = serve()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    require(all(n > 0 for n in launches.values()), f"kernel not launched: {launches}")
    ht, wt = TARGET_HW
    require(tuple(out["H21"].shape) == (N_PAIRS, 3, 3), "H21 shape")
    require(tuple(out["flow"].shape) == (N_PAIRS, 1, ht, wt, 2), "flow shape")
    require(tuple(out["match"].shape) == (N_PAIRS, ht, wt), "match shape")
    for key in ("H21", "flow", "match", "flow_down8", "match_down8"):
        require(bool(torch.isfinite(out[key]).all()), f"{key} is not finite")

    best_ms = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        serve()
        end.record()
        end.synchronize()
        best_ms = min(best_ms, start.elapsed_time(end))
    pairs_s = N_PAIRS / (best_ms / 1e3)
    print(f"(d) main path: {N_PAIRS} pairs, launches {launches}, found "
          f"{out['found'].tolist()}, inliers {out['num_inliers'].tolist()}, "
          f"best of 3: {best_ms:.1f} ms = {pairs_s:.3f} pairs/s "
          f"(fp32, scan, n_iter {N_ITER}) on {card}", flush=True)
    return launches


SOURCES = {
    "correlation_volume": ("ransacflow_tpu_torch/csrc/correlation.cu",
                           "ransacflow_tpu/ops/correlation.py:21"),
    "mutual_argmax": ("ransacflow_tpu_torch/csrc/matching.cu",
                      "ransacflow_tpu/ops/matching.py:24"),
    "ransac_score": ("ransacflow_tpu_torch/csrc/ransac.cu",
                     "ransacflow_tpu/ops/ransac.py:102"),
}


def main():
    try:
        card = phase_card()
        phase_build()
        results = phase_kernels()
        launches = phase_main_path(card)
    except Exception:  # the boundary: report and fail
        traceback.print_exc()
        return 1
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name],
                "max_abs_err": results[name]["max_abs_err"],
                "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
               for name, (src, rep) in SOURCES.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
