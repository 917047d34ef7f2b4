"""Anti-aliased downsampling (blur-pool), port of
`ransacflow_tpu/ops/blurpool.py:42` `blur_pool`.

Reflect pad, normalized binomial filter, depthwise conv with stride. It runs
inside the fine feature extractor, so it is a module on NCHW tensors, and
keeps its filter on the module's device.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class BlurPool(nn.Module):
    def __init__(self, channels, filt_size=3, stride=2):
        super().__init__()
        a = torch.tensor([math.comb(filt_size - 1, i) for i in range(filt_size)],
                         dtype=torch.float64)
        f = torch.outer(a, a)
        f = (f / f.sum()).float()
        # not in the state_dict: the checkpoint loaders drop the reference's
        # `filt` entries, which hold this same constant
        self.register_buffer("filt", f.expand(channels, 1, -1, -1).contiguous(),
                             persistent=False)
        self.stride = stride
        self.pad = ((filt_size - 1) // 2, -(-(filt_size - 1) // 2))

    def forward(self, x):
        lo, hi = self.pad
        x = F.pad(x, (lo, hi, lo, hi), mode="reflect")
        return F.conv2d(x, self.filt, stride=self.stride, groups=x.shape[1])
