"""Anti-aliased downsampling (blur-pool), port of
`ransacflow_tpu/ops/blurpool.py:42` `blur_pool`.

Reflect pad, normalized binomial filter, depthwise conv with stride. It runs
inside the fine feature extractor, so it is a module on NCHW tensors, and
keeps its filter on the module's device. The operation is kernel 9
(`kernels/blurpool.py`), with its backward.
"""

import torch.nn as nn

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
