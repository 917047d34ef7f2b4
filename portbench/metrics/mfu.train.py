"""Model FLOP utilization of the training step: the frozen count of a step
(`portbench/counts/flops.train_step_flops`, the backward at twice the
forward) times the steps of the untraced window, over that window on the
host clock, over the card's fp32 peak (TF32 off). Read in a traced run, on
the card only."""

from portbench.counts import flops
from portbench.metrics_common import on_card


def read(ctx):
    if not on_card(ctx) or ctx.get("kind") != "train":
        return None
    rec = ctx["rec"]
    per_step = flops.train_step_flops(ctx["pairs_per_step"], ctx["img_size"], ctx["kernel_size"])
    return 100.0 * per_step * rec["calls"] / rec["window_s"] / flops.PEAK_FLOPS["float32"]
