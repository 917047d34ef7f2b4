"""Median latency of the untraced window's calls (host clock, from the call
to its outputs on the host), in milliseconds. Read in a traced run, on the
card only."""

import numpy as np

from portbench.metrics_common import on_card


def read(ctx):
    lat = ctx.get("latencies_s")
    if not on_card(ctx) or ctx.get("kind") != "align" or not lat:
        return None
    return float(np.median(lat) * 1e3)
