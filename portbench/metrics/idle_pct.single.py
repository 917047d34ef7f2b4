"""Share of a call's time in which no operation runs on the device, as the
untraced window sees it: one less the device's busy time a call in the
traced window (the union of its device operations) over the wall time a
call in the untraced window. At one pair a call the profiler's host cost
would otherwise read as idle time: it slows every launch, not the
device's work."""

from portbench.metrics_common import on_card


def read(ctx):
    if not on_card(ctx):
        return None
    rec, trec = ctx["rec"], ctx["trace_rec"]
    busy_per_call = ctx["trace"].busy_s() / trec["calls"]
    return 100.0 * (1.0 - busy_per_call / (rec["window_s"] / rec["calls"]))
