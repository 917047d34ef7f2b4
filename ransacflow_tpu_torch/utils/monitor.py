"""Metrics logging (the port's copy of `MetricsLogger` from
`ransacflow_tpu/utils/monitor.py`, same file format)."""

import json
import os
import time


class MetricsLogger:
    """Append metrics dicts to <out_dir>/metrics.jsonl and echo to stdout."""

    def __init__(self, out_dir, echo=True):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self.echo = echo

    def log(self, step, **metrics):
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.echo:
            parts = ", ".join(f"{k} {v:.6f}" for k, v in metrics.items())
            print(f"[step {step}] {parts}", flush=True)
