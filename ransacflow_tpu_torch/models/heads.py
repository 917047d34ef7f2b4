"""Flow and matchability heads over the local correlation volume, port of
`ransacflow_tpu/models/heads.py:56-99`.

Both heads share one trunk shape: conv3x3 k^2 -> 512 -> 256 -> 128 with BN
and ReLU between, then conv3x3 to k^2 (flow: softmax expectation over the
offsets) or to 1 (matchability: sigmoid). All convs are bias-free and run
on cuDNN; the epilogues after conv4 are kernel 7 (`kernels/heads.py`).
"""

import torch.nn as nn
import torch.nn.functional as F

from ransacflow_tpu_torch.kernels.heads import flow_epilogue, match_epilogue
from ransacflow_tpu_torch.models.layers import conv, nchw, nhwc
from ransacflow_tpu_torch.ops.sampler import upsample_bilinear_x8

TRUNK = (512, 256, 128)


class Head(nn.Module):
    def __init__(self, kernel_size, out_ch):
        super().__init__()
        widths = (kernel_size * kernel_size,) + TRUNK
        for i in range(3):
            setattr(self, f"conv{i + 1}", conv(widths[i], widths[i + 1], 3, 1, 1))
            setattr(self, f"bn{i + 1}", nn.BatchNorm2d(widths[i + 1]))
        self.conv4 = conv(TRUNK[-1], out_ch, 3, 1, 1)

    def forward(self, x):
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return self.conv4(x)


def net_flow_coarse(net, corr, up8=True, kernel_size=7):
    """(B, H, W, k^2) correlation -> (B, H, W, 2) normalized residual flow
    (x then y), or (B, 8H, 8W, 2) with up8: the softmax expectation over the
    k x k offset grid, divided by the feature width/height, times 2."""
    flow = flow_epilogue(nhwc(net(nchw(corr))), kernel_size)
    return upsample_bilinear_x8(flow) if up8 else flow


def net_matchability(net, corr, up8=True):
    """(B, H, W, k^2) correlation -> (B, H, W, 1) matchability in (0, 1),
    or (B, 8H, 8W, 1) with up8."""
    m = match_epilogue(nhwc(net(nchw(corr))))
    return upsample_bilinear_x8(m) if up8 else m
