"""Building blocks shared by the networks (port of
`ransacflow_tpu/models/layers.py`).

The networks are `nn.Module`s with the reference's `state_dict` names and run
NCHW inside. Convolutions are bias-free `Conv2d`s (`conv`; the sky network's
classifier alone has a bias) and max pooling is `F.max_pool2d`, which pads
with -inf as the reference does. BatchNorm is `BatchNorm2d` (eps 1e-5,
momentum 0.1): in eval mode it normalizes with the running statistics; in
train mode it has the reference's semantics
(`ransacflow_tpu/models/layers.py:89-116`): the biased batch variance
normalizes, the unbiased one enters the running statistics. The
reference's int8 conv branch has no counterpart.

The two dtype policies of the reference (`:171-200`) follow its dtype flow
op by op, without autocast:
- `cast_params` (eval): every float parameter and buffer in the dtype, so
  the whole network runs in it; a convolution casts its input to its
  weight's dtype, as the reference's `conv2d` does (`:63`).
- `cast_compute_params` (training): the convolutions compute in the dtype
  from the fp32 master weights (their gradients arrive in fp32); BatchNorm
  keeps fp32 parameters and statistics, takes its moments in fp32 and
  returns fp32, as the reference's `(x - mean) * inv * w + b` promotes a
  bf16 input against fp32 moments (`:96-120`).
"""

import contextlib
import copy
import math

import torch
import torch.nn as nn


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` that computes in `compute_dtype` (None: its weight's
    dtype), its input and weight cast to it first."""

    compute_dtype = None

    def _conv_forward(self, x, weight, bias):
        dtype = self.compute_dtype or weight.dtype
        if x.dtype != dtype or weight.dtype != dtype:
            x, weight = x.to(dtype), weight.to(dtype)
            bias = None if bias is None else bias.to(dtype)
        return super()._conv_forward(x, weight, bias)


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` that casts its input to its parameters' dtype (a bf16
    convolution's output meets fp32 BatchNorm under the training policy) and,
    with `update_stats` False, normalizes a train-mode batch with its own
    moments without moving the running statistics or the batch count (a
    rematerialized forward must not count the batch twice). That runs the
    same op, with a zero momentum (the statistics times exactly 1, plus 0),
    so that it saves the same tensors for the backward as the first run."""

    update_stats = True

    def forward(self, x):
        if x.dtype != self.weight.dtype:
            x = x.to(self.weight.dtype)
        if self.update_stats or not self.training:
            return super().forward(x)
        momentum, count = self.momentum, self.num_batches_tracked
        self.momentum, self.num_batches_tracked = 0.0, None
        try:
            return super().forward(x)
        finally:
            self.momentum, self.num_batches_tracked = momentum, count


def conv(cin, cout, kernel_size, stride=1, padding=0, dilation=1):
    return Conv2d(cin, cout, kernel_size, stride, padding, dilation, bias=False)


def kaiming_normal_(conv_module, generator):
    """kaiming_normal_(mode='fan_out', nonlinearity='relu') from `generator`:
    std = sqrt(2 / (kh * kw * cout)), as `kaiming_normal_conv` draws it."""
    cout, _, kh, kw = conv_module.weight.shape
    with torch.no_grad():
        conv_module.weight.normal_(0.0, math.sqrt(2.0 / (kh * kw * cout)),
                                   generator=generator)


def l2_normalize(x, dim=-1, eps=1e-12):
    """``F.normalize(p=2)``: x / max(||x||_2, eps), the square-sum in fp32,
    the norm cast back to x's dtype and the division in it."""
    xf = x.float()
    norm = torch.sqrt((xf * xf).sum(dim=dim, keepdim=True)).to(x.dtype)
    return x / norm.clamp_min(eps)


def as_dtype(dtype):
    """A torch dtype, or its name ('bfloat16'); None stays None."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def cast_params(net, dtype):
    """The eval policy: a copy of `net` with every float parameter and buffer
    in `dtype` (BatchNorm's included), so that the whole network runs in it.
    The caller's network is left as it is."""
    return copy.deepcopy(net).to(as_dtype(dtype))


@contextlib.contextmanager
def cast_compute_params(nets, dtype):
    """The training policy inside the block: every convolution of `nets`
    computes in `dtype` (None: nothing changes) from its fp32 master weight;
    BatchNorm stays fp32. The convolutions' previous settings come back
    after the block."""
    convs = [m for net in nets for m in net.modules() if isinstance(m, Conv2d)]
    saved = [m.compute_dtype for m in convs]
    if dtype is not None:
        for m in convs:
            m.compute_dtype = as_dtype(dtype)
    try:
        yield
    finally:
        for m, d in zip(convs, saved):
            m.compute_dtype = d


@contextlib.contextmanager
def frozen_bn_stats(net, frozen=True):
    """Inside the block the train-mode BatchNorms of `net` leave their
    running statistics alone (`BatchNorm2d.update_stats`)."""
    bns = [m for m in net.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.update_stats = not frozen
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    """NCHW -> contiguous NHWC, the layout of the public functions."""
    return x.permute(0, 2, 3, 1).contiguous()
