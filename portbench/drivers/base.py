"""What every driver shares: set-up, the closed-loop window on the host
clock, the optional traced window under the profiler that follows it, the
device's memory peak and the launch counts of the program's hand
kernels."""

import time

import torch

from portbench.trace import WINDOW_SPAN, Trace

FP32 = "float32, TF32 off"
# the traced window's longest: its per-layer readings are rates and shares,
# and reading the profiler's events takes seconds per second traced
TRACE_SECONDS = 10.0
CONTROL_PRECISION = "TF32 (the control)"


class Session:
    """A driver subclasses this with `setup()` (weights, inputs, warm-up),
    `call(i)` (the i-th request or step of the window; returns when its
    outputs are on the host, or enqueues a step), `sync()` (waits for what
    the window enqueued), `end_to_end(rec)`, `context(rec)` (what the
    per-layer readers read) and `judge()`."""

    units_per_call = 1

    def __init__(self, cfg, mix, seed, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, int(seed), torch.device(device)
        self.on_card = self.device.type == "cuda"

    def generator(self, stream):
        """A generator on the device for one named stream of draws, seeded
        from the run's seed and the stream's name."""
        salt = sum((i + 1) * ord(c) for i, c in enumerate(stream))
        return torch.Generator(device=self.device).manual_seed(
            (self.seed * 1000003 + salt) % (2 ** 63))

    def set_precision(self):
        """The configuration's precision: float32 with TF32 off, the
        program's own policy (`device.use_full_fp32`). The control runs
        the program with TF32 on instead (`CONTROL_PRECISION`)."""
        import torch.backends.cuda
        import torch.backends.cudnn

        precision = self.cfg["precision"]
        if precision not in (FP32, CONTROL_PRECISION):
            raise ValueError(f"unsupported precision {precision!r}")
        if precision == FP32:
            from ransacflow_tpu_torch.device import use_full_fp32

            use_full_fp32()
        else:
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True

    def _sync(self):
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def measure(self, seconds, trace=False, setup_started=None):
        """Set up, then run calls back to back until `seconds` have passed on
        the host clock, the window closing at a call boundary. With `trace`
        a second window of at most `TRACE_SECONDS` follows under
        `torch.profiler`: the host-clock readings (the end-to-end metrics,
        latencies, the memory peak) stay those of the untraced window, which
        the profiler's host cost does not slow."""
        self.setup()
        self._sync()
        setup_peak = torch.cuda.max_memory_allocated(self.device) if self.on_card else 0
        rec = self._window(seconds)
        rec["setup_s"] = rec["t_first"] - setup_started if setup_started is not None else None
        ctx = {"rec": rec}
        res = {"end_to_end": self.end_to_end(rec)}
        peak = max(setup_peak, rec["window_peak_bytes"])
        units = rec["units"]
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.on_card else [])
            with profile(activities=acts) as prof:
                trec = self._window(min(seconds, TRACE_SECONDS))
            tr = Trace(prof)
            ctx["trace"], ctx["trace_rec"] = tr, trec
            peak = max(peak, trec["window_peak_bytes"])
            units += trec["units"]
            res["busy_s"] = tr.busy_s()
            res["window_s"] = tr.window_s()
            res["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
        # a call that raises ends the run (no result), so none failed here
        res.update({"attempted": units, "failed": 0, "memory_peak_bytes": peak})
        ctx.update(self.context(rec))
        res["context"] = ctx
        self.free_program()
        return res

    def _window(self, seconds):
        """Calls 0, 1, ... back to back until `seconds` have passed, then
        waits for their work. Returns the window's record,
        with the memory peak and the hand kernels' launches counted from
        its start."""
        from ransacflow_tpu_torch import kernels

        if self.on_card:
            torch.cuda.reset_peak_memory_stats(self.device)
        kernels.reset_launch_counts()
        starts, ends = [], []
        with torch.profiler.record_function(WINDOW_SPAN):
            t_first = time.perf_counter()
            i = 0
            while True:
                starts.append(time.perf_counter())
                self.call(i)
                ends.append(time.perf_counter())
                i += 1
                if ends[-1] - t_first >= seconds:
                    break
            self.sync()
            t_end = time.perf_counter()
        return {"calls": len(starts), "starts": starts, "ends": ends, "t_first": t_first,
                "t_end": t_end, "window_s": t_end - t_first,
                "launches": kernels.launch_counts(),
                "window_peak_bytes": (torch.cuda.max_memory_allocated(self.device)
                                      if self.on_card else 0),
                "units": len(starts) * self.units_per_call}

    def sync(self):
        self._sync()

    def free_program(self):
        """Drops the program's state before the reference runs."""
        if self.on_card:
            torch.cuda.empty_cache()
