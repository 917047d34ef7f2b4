"""Device milliseconds a pair under cuDNN's convolutions (the host
operations `aten::cudnn_convolution` and kin) in the traced window: the
trunk, the fine feature extractor and the heads."""

from portbench.metrics_common import CONV_OPS


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "align" or tr is None:
        return None
    s = tr.launched_by_s(CONV_OPS)
    return 1e3 * s / ctx["trace_rec"]["units"] if s > 0 else None
