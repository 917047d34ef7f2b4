"""A copy of the benchmark's tree at tiny sizes for CPU tests, and a way to
drive a run of it in a fresh process (everything but the look for a card)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "portbench"

TINY_ALIGN = {"min_size": 64, "target_hw": [64, 64], "nb_scale": 3, "n_hypotheses": 256}
TINY_TRAIN = {"img_size": 32, "margin": 8}
TINY_MIX = {
    "batch32": {"pairs_per_call": 2, "pool_calls": 2, "warm_calls": 1, "judge_pairs": 2,
                "shifts_px": [-16, 16]},
    "single": {"pool_calls": 2, "warm_calls": 1, "judge_pairs": 2, "shifts_px": [-16, 16]},
    "b16": {"pairs_per_step": 2, "pool_steps": 4},
}


def load(path):
    with open(path) as f:
        return json.load(f)


def dump(path, obj):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def tiny_tree(root):
    """Copies BENCHMARK.json and portbench/ (not its tests) under `root`,
    with the configurations and mixes cut to sizes a CPU test can hold.
    Returns the root."""
    root = Path(root)
    shutil.copytree(BENCH, root / "portbench", ignore=shutil.ignore_patterns(
        "tests", "__pycache__", "*.pyc"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for name, sizes in (("align480", TINY_ALIGN), ("train_stage3", TINY_TRAIN)):
        cfg = load(root / "portbench" / "configs" / f"{name}.json")
        cfg["settings"].update(sizes)
        dump(root / "portbench" / "configs" / f"{name}.json", cfg)
    for name, sizes in TINY_MIX.items():
        mix = load(root / "portbench" / "traffic" / f"{name}.json")
        mix.update(sizes)
        dump(root / "portbench" / "traffic" / f"{name}.json", mix)
    return root


RUNNER = """
import json, sys, types
sys.path.insert(0, {root!r})
{fault}
from portbench import run
args = types.SimpleNamespace(workload={workload!r}, seed={seed}, seconds={seconds},
                             trace={trace}, t0=0.0)
bench = run.load_json({bench!r})
print(json.dumps(run.run(args, bench, device="cpu", chips_checked={{"name": "cpu",
                                                                   "count": 1}})))
"""


def run_cell(root, workload, seed=7, seconds=0.3, trace=0, fault=""):
    """The result line of one run of `workload` from the tree at `root`, on
    the CPU, in a fresh process; `fault` is code run first (a patch of the
    program). Returns (result dict, the process's stderr)."""
    code = RUNNER.format(root=str(root), fault=fault, workload=workload, seed=seed,
                         seconds=seconds, trace=trace, bench=str(Path(root) / "BENCHMARK.json"))
    env = {**os.environ, "PYTHONPATH": f"{root}{os.pathsep}{REPO}"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"run failed ({proc.returncode}): {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr
