"""Reading a torch.profiler trace of the measured window: the device's busy
time, the time by device operation, the idle gaps by what the host was
doing, and the device time of the kernels that named host operations
launched.

It reads the profiler's raw events (`prof.profiler.kineto_results`), not
`prof.events()`: building the latter's event tree for a window of a
million host operations takes minutes.
"""

import bisect
import collections

from torch.autograd import DeviceType

WINDOW_SPAN = "portbench.window"


class Trace:
    """The events of one traced window, times in microseconds. The window
    is the host span `WINDOW_SPAN` that the harness records around it."""

    def __init__(self, prof):
        self.device = []   # (start, end, name, linked host correlation id)
        self.host = []     # (start, end, name, correlation id)
        self.window_us = None
        for e in prof.profiler.kineto_results.events():
            kind = e.device_type()
            if kind == DeviceType.CUDA:
                # a host span's mirror on the device's timeline is no work
                if not e.is_user_annotation():
                    self.device.append((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name(),
                                        e.linked_correlation_id()))
            elif kind == DeviceType.CPU:
                if e.name() == WINDOW_SPAN:
                    self.window_us = (e.start_ns() / 1e3, e.end_ns() / 1e3)
                else:
                    self.host.append((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name(),
                                      e.correlation_id()))
        self.device.sort()
        self.host.sort()
        if self.window_us is None and self.device:
            self.window_us = (self.device[0][0], self.device[-1][1])

    def busy_intervals(self):
        """The union of the device operations' intervals inside the window."""
        lo, hi = self.window_us
        merged = []
        for s, e, _, _ in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def window_s(self):
        lo, hi = self.window_us
        return (hi - lo) / 1e6

    def device_ops(self, top=10):
        """[[name, seconds]] of the device operations that took most time."""
        by = collections.Counter()
        for s, e, name, _ in self.device:
            by[name] += (e - s) / 1e6
        return [[n, v] for n, v in by.most_common(top)]

    def device_time_s(self, predicate):
        """Seconds of device operations whose name satisfies `predicate`."""
        return sum(e - s for s, e, n, _ in self.device if predicate(n)) / 1e6

    def launched_by_s(self, names):
        """Seconds of the device operations that the host operations of
        `names` launched themselves (not their children's)."""
        ids = {c for _, _, n, c in self.host if n in names}
        return sum(e - s for s, e, _, link in self.device if link in ids) / 1e6

    def idle_gaps(self, top=10):
        """[[host activity, seconds]]: the window's idle gaps on the device,
        each charged to the innermost host operation running at its middle,
        summed by that operation's name, the longest first."""
        lo, hi = self.window_us
        gaps, at = [], lo
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        starts = [h[0] for h in self.host]
        by = collections.Counter()
        for s, e in gaps:
            mid = (s + e) / 2
            best = None
            i = bisect.bisect_right(starts, mid)
            # the innermost span that covers `mid` among the last ones begun
            for h in reversed(self.host[max(0, i - 64):i]):
                if h[1] >= mid and (best is None or h[1] - h[0] < best[1] - best[0]):
                    best = h
            by[best[2] if best else "host outside any operation"] += (e - s) / 1e6
        return [[n, v] for n, v in by.most_common(top)]
