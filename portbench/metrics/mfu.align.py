"""Model FLOP utilization of the serving path: the frozen count of a pair
(`portbench/counts/flops.fused_align_flops`) times the pairs of the
untraced window, over that window on the host clock, over the card's fp32
peak (TF32 off). Read in a traced run, on the card only."""

from portbench.counts import flops
from portbench.metrics_common import on_card


def read(ctx):
    if not on_card(ctx) or ctx.get("kind") != "align":
        return None
    rec = ctx["rec"]
    per_pair = flops.fused_align_flops(ctx["shapes"], ctx["target_hw"],
                                       ctx["n_hypotheses"], ctx["kernel_size"])["total"]
    return 100.0 * per_pair * rec["units"] / rec["window_s"] / flops.PEAK_FLOPS["float32"]
