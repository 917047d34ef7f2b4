"""Anti-aliased downsampling (blur-pool), port of
`ransacflow_tpu/ops/blurpool.py`.

`BlurPool` is the 2-D form, `ransacflow_tpu/ops/blurpool.py:42` `blur_pool`:
reflect pad, normalized binomial filter, depthwise conv with stride. It runs
inside the fine feature extractor, so it is a module on NCHW tensors, and
keeps its filter on the module's device. The operation is kernel 9
(`kernels/blurpool.py`), with its backward.

`blur_pool_1d` is the 1-D form on (B, L, C), which the reference vendors
but never calls; the JAX package computes it with a plain convolution, and
so does the port.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ransacflow_tpu_torch.kernels.blurpool import binomial_filter, blur_pool


class BlurPool(nn.Module):
    def __init__(self, channels, filt_size=3, stride=2):
        super().__init__()
        # not in the state_dict: the checkpoint loaders drop the reference's
        # `filt` entries, which hold this same constant
        self.register_buffer("filt", binomial_filter(channels, filt_size),
                             persistent=False)
        self.stride = stride

    def forward(self, x):
        return blur_pool(x, self.filt, self.stride)


def blur_pool_1d(x, filt_size=3, stride=2):
    """1-D anti-aliased downsample along the middle axis of (B, L, C): reflect
    pad, the normalized binomial filter of `filt_size` taps, depthwise conv
    with `stride` (the reference's Downsample1D, model/downsample.py:60-100).
    Returns (B, L', C)."""
    a = torch.tensor([math.comb(filt_size - 1, i) for i in range(filt_size)],
                     dtype=torch.float32)
    c = x.shape[-1]
    kernel = (a / a.sum()).to(x.device, x.dtype).expand(c, 1, filt_size)
    pad_lo, pad_hi = (filt_size - 1) // 2, -(-(filt_size - 1) // 2)
    y = F.pad(x.transpose(1, 2), (pad_lo, pad_hi), mode="reflect")
    return F.conv1d(y, kernel, stride=stride, groups=c).transpose(1, 2)
