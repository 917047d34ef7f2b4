"""Device milliseconds a training step under cuDNN's convolutions, forward
and backward (the host operations `aten::cudnn_convolution`,
`aten::convolution_backward` and kin) in the traced window."""

from portbench.metrics_common import CONV_OPS


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "train" or tr is None:
        return None
    s = tr.launched_by_s(CONV_OPS)
    return 1e3 * s / ctx["trace_rec"]["calls"] if s > 0 else None
