"""Building blocks shared by the networks (port of
`ransacflow_tpu/models/layers.py`).

The networks are `nn.Module`s with the reference's `state_dict` names and run
NCHW inside. Convolutions are bias-free fp32 `nn.Conv2d` (`conv`; the sky
network's classifier alone has a bias) and max pooling
is `F.max_pool2d`, which pads with -inf as the reference does. BatchNorm is
`nn.BatchNorm2d` (eps 1e-5, momentum 0.1): in eval mode it normalizes with
the running statistics; in train mode it has the reference's semantics
(`ransacflow_tpu/models/layers.py:89-116`): the biased batch variance
normalizes, the unbiased one enters the running statistics. The
reference's int8 conv branch has no counterpart.
"""

import math

import torch
import torch.nn as nn


def conv(cin, cout, kernel_size, stride=1, padding=0, dilation=1):
    return nn.Conv2d(cin, cout, kernel_size, stride, padding, dilation, bias=False)


def kaiming_normal_(conv_module, generator):
    """kaiming_normal_(mode='fan_out', nonlinearity='relu') from `generator`:
    std = sqrt(2 / (kh * kw * cout)), as `kaiming_normal_conv` draws it."""
    cout, _, kh, kw = conv_module.weight.shape
    with torch.no_grad():
        conv_module.weight.normal_(0.0, math.sqrt(2.0 / (kh * kw * cout)),
                                   generator=generator)


def l2_normalize(x, dim=-1, eps=1e-12):
    """``F.normalize(p=2)``: x / max(||x||_2, eps), the square-sum in fp32."""
    xf = x.float()
    norm = torch.sqrt((xf * xf).sum(dim=dim, keepdim=True)).to(x.dtype)
    return x / norm.clamp_min(eps)


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    """NCHW -> contiguous NHWC, the layout of the public functions."""
    return x.permute(0, 2, 3, 1).contiguous()
