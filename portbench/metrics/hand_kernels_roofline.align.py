"""The hand kernels' share of their roofline on the serving path: the sum
of the frozen bounds of every launch of the traced window
(`portbench/counts/roofline.align_bounds`) over the device time of the hand
kernels' device operations."""

from portbench.metrics_common import roofline_share
from portbench.counts import roofline


def read(ctx):
    if ctx.get("kind") != "align" or ctx.get("trace") is None:
        return None
    n_valid = getattr(ctx["session"], "valid_matches_mean", None)
    if n_valid is None:
        return None
    src_hw = ctx["shapes"][0]
    bounds = roofline.align_bounds(ctx["pairs_per_call"], src_hw, ctx["shapes"],
                                   ctx["target_hw"], ctx["n_hypotheses"], n_valid,
                                   ctx["kernel_size"])
    return roofline_share(ctx, bounds)
