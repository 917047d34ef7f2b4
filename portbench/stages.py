"""The program's stage spans in a traced window (`portbench/trace.Trace`):
the device time each stage launched, and the device's idle time while the
host was inside a stage.

The program records a stage as a host span (`torch.profiler.record_function`:
`rf.align.features`, `rf.train.backward`, ...). A device operation belongs
to stage S when the host event that launched it (the host event whose
correlation id is the operation's linked correlation id) began inside an
instance of S. The test goes by time and not by thread: autograd launches
the backward's kernels from its own thread while the main thread is inside
`rf.train.backward`. An operation with no linked host event belongs to no
stage: on the card, the kernels that the program launches through ctypes
outside an autograd Function link to none (PERF.md section 5). The spans
are named here as strings; nothing of the program is imported.
"""

import bisect
import re

from portbench.metrics_common import on_card

# Host events that hold correlation ids of another count than the
# operations' and spans': the CUDA API's calls (`cuda*`, `cu*`: CUPTI's
# ids) and CUPTI's overhead markers. On the card their ids collide with
# the operations' (thousands in a few seconds traced), and a device
# operation links to an operation, never to one of them.
_API_CALL = re.compile(r"cu(da)?[A-Z]")
_PROFILER_MARKERS = frozenset({
    "Command Buffer Full", "Activity Buffer Request", "Buffer Flush", "Driver Compiler",
    "Instrumentation", "Resource", "Runtime Triggered Module Loading",
    "Lazy Function Loading", "UVM Activity Initialization", "Unknown"})


def can_launch(name):
    """Whether a host event named `name` can be the one a device operation
    links to: an operation or a span, not a CUDA call or a profiler
    marker."""
    return not (_API_CALL.match(name) or name in _PROFILER_MARKERS)


class Stages:
    """The stage readings of one trace, times in microseconds as the
    trace's."""

    def __init__(self, trace):
        self.trace = trace
        self._spans = {}
        self._launched_at = None

    def spans(self, name):
        """[(start, end)] of the host spans named `name`, by start."""
        if name not in self._spans:
            self._spans[name] = sorted((s, e) for s, e, n, _ in self.trace.host if n == name)
        return self._spans[name]

    def launched_at(self):
        """{correlation id: start} of the host events that can launch (id 0
        links nothing)."""
        if self._launched_at is None:
            self._launched_at = {c: s for s, _, n, c in self.trace.host
                                 if c and can_launch(n)}
        return self._launched_at

    def device_s(self, name):
        """Seconds of the device operations launched inside a span `name`."""
        spans = self.spans(name)
        starts = [s for s, _ in spans]
        at = self.launched_at()
        total = 0.0
        for s, e, _, link in self.trace.device:
            t = at.get(link)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += e - s
        return total / 1e6

    def unlinked_s(self):
        """Seconds of the device operations with no linked host event."""
        at = self.launched_at()
        return sum(e - s for s, e, _, link in self.trace.device if link not in at) / 1e6

    def idle_intervals(self):
        """The traced window less the union of the device operations."""
        lo, hi = self.trace.window_us
        out, at = [], lo
        for s, e in self.trace.busy_intervals():
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if hi > at:
            out.append((at, hi))
        return out

    def idle_s(self, name):
        """Seconds of the window in which the device ran nothing while the
        host was inside a span `name`."""
        return overlap_us(self.idle_intervals(), union(self.spans(name))) / 1e6


def union(intervals):
    """Sorted, disjoint intervals covering the same time as `intervals`."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def overlap_us(a, b):
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def of(ctx):
    """The run's `Stages`, made once a run and kept in the readers' context;
    None where the run traced no card."""
    if not on_card(ctx):
        return None
    if "stages" not in ctx:
        ctx["stages"] = Stages(ctx["trace"])
    return ctx["stages"]


def _per(ctx, kind, name, per, reading):
    """`reading` (seconds) of span `name` in milliseconds per unit ("units":
    pairs) or per call ("calls": requests or steps) of the traced window;
    None off the card, in a cell of another kind, or where the trace holds
    no span `name`."""
    st = of(ctx)
    if st is None or ctx.get("kind") != kind or not st.spans(name):
        return None
    return 1e3 * reading(st, name) / ctx["trace_rec"][per]


def device_ms(ctx, kind, name, per):
    """Device milliseconds launched inside span `name`, per unit or call."""
    return _per(ctx, kind, name, per, Stages.device_s)


def idle_ms(ctx, kind, name, per):
    """The device's idle milliseconds inside span `name`, per unit or call."""
    return _per(ctx, kind, name, per, Stages.idle_s)
