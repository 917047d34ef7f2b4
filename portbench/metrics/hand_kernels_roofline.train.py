"""The hand kernels' share of their roofline in the training step: the sum
of the frozen bounds of every launch of the traced window
(`portbench/counts/roofline.train_bounds`) over the device time of the hand
kernels' device operations."""

from portbench.metrics_common import roofline_share
from portbench.counts import roofline


def read(ctx):
    if ctx.get("kind") != "train" or ctx.get("trace") is None:
        return None
    bounds = roofline.train_bounds(ctx["pairs_per_step"], ctx["img_size"], ctx["kernel_size"])
    return roofline_share(ctx, bounds)
