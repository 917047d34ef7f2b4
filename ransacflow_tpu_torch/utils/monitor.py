"""Metrics logging and profiling hooks (port of
`ransacflow_tpu/utils/monitor.py`, same file formats): a JSONL metrics
logger with stdout summaries, monitoring images written as PNGs, per-stage
wall timers, a `torch.profiler` trace in place of JAX's profiler, and the
named spans the program records in that trace.
"""

import contextlib
import json
import os
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


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

    def log_image(self, step, name, tensor, kind="auto"):
        """Write a monitoring image to <out_dir>/images/<name>_<step>.png and
        return its path. kind: 'auto' (`tensor2image`) or 'flow'
        (`flow2image`'s HSV wheel). The reference pushed these to Visdom
        (utils/monitor.py:39-56)."""
        from PIL import Image

        img = flow2image(tensor) if kind == "flow" else tensor2image(tensor)
        d = os.path.join(os.path.dirname(self.path), "images")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{name}_{step}.png")
        Image.fromarray(img).save(path)
        return path


def _numpy(x):
    """A tensor on any device (detached, on the host) or an array, as a
    float32 numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def tensor2image(tensor):
    """Tensor or array -> uint8 HWC image for visual monitoring (the
    reference's utils/monitor.py:5-17): a PIL image passes through; a
    1-channel map gets a jet colormap of (1 - x) (cv2's
    ``applyColorMap(255 - x, JET)`` in numpy); RGB is scaled to [0, 255].
    Takes (B, H, W, C) channels-last (the first image) or (H, W[, C])."""
    if "PIL" in str(type(tensor)):
        return np.array(tensor)
    arr = _numpy(tensor)
    if arr.ndim == 4:
        arr = arr[0]
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.shape[-1] == 1:
        x = 1.0 - np.clip(arr[..., 0], 0.0, 1.0)
        r = np.clip(1.5 - np.abs(4.0 * x - 3.0), 0, 1)
        g = np.clip(1.5 - np.abs(4.0 * x - 2.0), 0, 1)
        b = np.clip(1.5 - np.abs(4.0 * x - 1.0), 0, 1)
        arr = np.stack([r, g, b], axis=-1)
    return (255.0 * np.clip(arr, 0.0, 1.0)).astype(np.uint8)


def flow2image(flow):
    """(H, W, 2) or (B, H, W, 2) normalized flow -> uint8 HSV-wheel image:
    the direction is the hue, the magnitude over its 99th percentile the
    saturation."""
    f = _numpy(flow)
    if f.ndim == 4:
        f = f[0]
    mag = np.sqrt(f[..., 0] ** 2 + f[..., 1] ** 2)
    ang = (np.arctan2(f[..., 1], f[..., 0]) + np.pi) / (2 * np.pi)
    sat = np.clip(mag / (np.percentile(mag, 99) + 1e-8), 0, 1)
    h6 = ang * 6.0
    k = np.floor(h6)
    fpart = h6 - k
    p = 1.0 - sat
    q = 1.0 - sat * fpart
    t = 1.0 - sat * (1.0 - fpart)
    one = np.ones_like(sat)
    lut = [(one, t, p), (q, one, p), (p, one, t), (p, q, one), (t, p, one), (one, p, q)]
    rgb = np.zeros(f.shape[:2] + (3,), np.float32)
    for i in range(6):
        m = (k.astype(int) % 6) == i
        for c in range(3):
            rgb[..., c][m] = lut[i][c][m]
    return (rgb * 255).astype(np.uint8)


class StageTimer:
    """Accumulate wall time per named stage; `report()` prints a summary.

    It reads the host's clock. CUDA launches return before the card is
    done, so a stage's device work lands on whichever later stage waits for
    the card (a read-back, a synchronize), as it does under JAX's
    asynchronous dispatch."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def time(self, name):
        """Times the block under `name`; it is also the span `name` in a
        profiler's trace (`span`)."""
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self):
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: total {total:.3f}s, {n} calls, "
                         f"{total / n * 1000:.1f} ms/call")
        return "\n".join(lines)


_NO_SPAN = contextlib.nullcontext()


def span(name):
    """A named span of the host's timeline: `torch.profiler.record_function`
    while a profiler runs, else a shared no-op context. The check is one
    read of a flag, so a span costs nothing worth counting untraced; it
    adds no synchronize, no read-back and no device work, and changes no
    number. The spans land in the profiler's trace on the device's clock,
    nested as they were opened."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def profile_trace(log_dir, enabled=True):
    """Trace the block with `torch.profiler` (the host's activity, and the
    card's when CUDA is there) and write it under `log_dir` through
    `tensorboard_trace_handler`: one `<host>_<pid>.<ms>.pt.trace.json`, a
    Chrome trace that TensorBoard's profiler plugin, Perfetto or
    chrome://tracing opens. A no-op when `enabled` is false.

    The trace holds the program's spans (`span`): `rf.align`, a serving
    request (`pipeline/fused.fused_align`, `fused_align_batch`), over its
    stages `rf.align.features` (the trunk's banks and the target's
    features), `rf.align.matching` (the score and kernel 2), `rf.align.fit`
    (RANSAC) and `rf.align.fine` (the fine stage); `rf.train.step`
    (`train/trainer.train_step`) over `rf.train.forward` (the losses),
    `rf.train.backward` (the backward and the gradients' reduction) and
    `rf.train.optimizer` (Adam); and a `StageTimer`'s stages under their
    own names."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
