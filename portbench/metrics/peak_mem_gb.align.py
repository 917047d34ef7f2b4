"""The device's memory peak over the untraced window (`max_memory_allocated`
after a reset at the window's start), in GB (1e9 bytes)."""

from portbench.metrics_common import on_card


def read(ctx):
    if not on_card(ctx):
        return None
    peak = ctx["rec"]["window_peak_bytes"]
    return peak / 1e9 if peak else None
