"""Helpers that several per-layer metric readers share."""

from portbench.counts import roofline

# the host operations under which cuDNN's convolutions, forward and
# backward, launch their device work
CONV_OPS = frozenset({"aten::cudnn_convolution", "aten::cudnn_convolution_transpose",
                      "aten::convolution_backward"})


def on_card(ctx):
    """Whether the run traced the card: a CPU run writes no device metric."""
    tr = ctx.get("trace")
    return tr is not None and bool(tr.device)


def idle_pct(ctx):
    if not on_card(ctx):
        return None
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())


def roofline_share(ctx, bounds):
    """Percent: the launches' bounds over the hand kernels' device time;
    None when the trace holds no hand kernel. A launch the bounds do not
    know counts 0 (it lowers the share, never raises it)."""
    if not on_card(ctx):
        return None
    device_s = ctx["trace"].device_time_s(roofline.is_hand_kernel)
    if device_s <= 0:
        return None
    launches = ctx["trace_rec"]["launches"]
    bound = sum(n * bounds.get(name, 0.0) for name, n in launches.items())
    return 100.0 * bound / device_s
