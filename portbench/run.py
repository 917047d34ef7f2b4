"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, `portbench/` and
the program (`ransacflow_tpu_torch`). The cell names its configuration
(`portbench/configs/<config>.json`) and its traffic mix
(`portbench/traffic/<traffic>.json`); the mix names the driver
(`portbench/drivers/<driver>.py`) that generates its inputs from the seed
and drives the program. The run makes its weights and inputs from the seed,
warms up the cell's shapes, measures for `--seconds`, then judges a sample
of what the window produced against the plain reference
(`portbench/reference/`), and prints one JSON line last on standard output.
With `--trace 1` a second window of at most 10 s follows under
`torch.profiler`, and the line holds the cell's per-layer metrics
(`portbench/metrics/<metric>.py`) instead of its end-to-end ones.

A run exits 2 without a result when there is no CUDA card, fewer cards than
the cell asks for, or the program cannot be imported; 3 when JAX or the JAX
package was loaded.
"""

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ransacflow_tpu")


def process_start_s():
    """Seconds since this process started, from /proc (the time at import of
    this module where /proc is unreadable)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
        with open("/proc/uptime") as f:
            return float(f.read().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


class Refused(Exception):
    """The run cannot be made here; no result is printed."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_of(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise Refused(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench, cell, section):
    """The metrics of `section` that the cell reports: those that list it,
    and those without a list that move (or are) a metric the cell reports."""
    out = []
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]}
    for m in bench[section]:
        listed = m.get("workloads")
        if listed is not None:
            if cell["name"] in listed:
                out.append(m)
        elif m["name"] in e2e or m.get("moves") in e2e:
            out.append(m)
    return out


def forbidden_modules():
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_info(chips):
    """Requires `chips` CUDA cards; prints and returns their name, count and
    power limit."""
    import torch

    if not torch.cuda.is_available():
        raise Refused("no CUDA card: the benchmark measures the port on the card only")
    count = torch.cuda.device_count()
    if count < chips:
        raise Refused(f"the cell needs {chips} cards, {count} present")
    name = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        power = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        power = "unknown"
    print(f"card: {name}; cards: {count}; nvidia-smi: {power}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    return {"name": name, "count": count, "power": power}


def read_layer_metrics(metrics, ctx):
    """{name: {value, unit}} of the per-layer metrics whose reader finds
    something to read; a reader that finds nothing returns None and its
    metric is left out."""
    out = {}
    for m in metrics:
        mod = load_module(ROOT / "metrics" / f"{m['name']}.py", "portbench_metric_" + m["name"])
        value = mod.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run(args, bench, device="cuda", chips_checked=None):
    """One run of the cell; returns the result dict (not yet printed)."""
    cell = cell_of(bench, args.workload)
    cfg = load_json(ROOT / "configs" / f"{cell['config']}.json")
    mix = load_json(ROOT / "traffic" / f"{cell['traffic']}.json")
    card = chips_checked or {"name": None, "count": cell["chips"]}
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    session = driver.Session(cfg, mix, args.seed, device)
    res = session.measure(args.seconds, bool(args.trace), setup_started=args.t0)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr, flush=True)
        raise SystemExit(3)
    checks = session.judge()
    correct = all(c["value"] <= c["limit"] for c in checks)
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr,
              flush=True)
    if args.trace:
        metrics = read_layer_metrics(metrics_of(bench, cell, "per_layer"),
                                     {**res["context"], "device_name": card["name"]})
    else:
        want = {m["name"]: m["unit"] for m in metrics_of(bench, cell, "end_to_end")}
        metrics = {k: {"value": float(v), "unit": want[k]}
                   for k, v in res["end_to_end"].items() if k in want}
    device_rec = {"platform": "gpu", "kind": card["name"], "count": card["count"],
                  "memory_peak_bytes": int(res["memory_peak_bytes"])}
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics, "device": device_rec}
    if args.trace:
        device_rec["busy_s"] = res["busy_s"]
        device_rec["window_s"] = res["window_s"]
        out["breakdown"] = res["breakdown"]
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return out


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    args.t0 = time.perf_counter() - process_start_s()
    return args


def main(argv=None):
    args = parse(argv)
    try:
        bench_path = Path.cwd() / "BENCHMARK.json"
        if not bench_path.exists():
            raise Refused("no BENCHMARK.json in the working directory")
        bench = load_json(bench_path)
        cell = cell_of(bench, args.workload)
        if importlib.util.find_spec("ransacflow_tpu_torch") is None:
            raise Refused("the program (ransacflow_tpu_torch) is not in this checkout")
        card = card_info(cell["chips"])
        out = run(args, bench, chips_checked={"name": card["name"], "count": cell["chips"]})
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        return 2
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
