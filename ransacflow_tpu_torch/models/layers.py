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

from ransacflow_tpu_torch.parallel.group import all_reduce_sum, world_size


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
    so that it saves the same tensors for the backward as the first run.

    With `sync_group` a process group of more than one rank
    (`synced_batch_norm`), a train-mode batch is normalized with the moments
    of the global batch (`_synced_forward`); without one it is the
    `nn.BatchNorm2d` call, bit for bit."""

    update_stats = True
    sync_group = None

    def forward(self, x):
        if x.dtype != self.weight.dtype:
            x = x.to(self.weight.dtype)
        if self.training and world_size(self.sync_group) > 1:
            return self._synced_forward(x)
        if self.update_stats or not self.training:
            return super().forward(x)
        momentum, count = self.momentum, self.num_batches_tracked
        self.momentum, self.num_batches_tracked = 0.0, None
        try:
            return super().forward(x)
        finally:
            self.momentum, self.num_batches_tracked = momentum, count

    def _synced_forward(self, x):
        """The port of the reference's `batch_norm(axis_name=...)`
        (`ransacflow_tpu/models/layers.py:76-110`): the per-channel sums of
        x and x^2 (fp32) and the element count all-reduced together in one
        `all_reduce_sum`, whose backward carries the moments' cotangents
        across the ranks; the biased variance E[x^2] - E[x]^2 normalizes,
        the running variance takes the unbiased one over the global count.
        Under `update_stats` False the running statistics stay."""
        c = x.shape[1]
        stats = torch.cat([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)),
                           x.new_full((1,), x.numel() // c)])
        stats = all_reduce_sum(stats, self.sync_group)
        n = stats[2 * c]
        mean = stats[:c] / n
        var = stats[c:2 * c] / n - mean * mean
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var * (n / (n - 1).clamp_min(1)))
                self.num_batches_tracked.add_(1)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean.view(1, c, 1, 1)) * scale.view(1, c, 1, 1)
                + self.bias.view(1, c, 1, 1))


def fold_bn(conv_module, bn):
    """`bn(conv_module(x))` under an eval-mode BatchNorm as one convolution
    and a bias: w' = w * s and b' = beta - mean * s per output channel, s =
    gamma / sqrt(var + eps), computed in fp64. Returns w' contiguous in
    fp32 and b' in fp64 (a block sums two biases before it rounds). With
    `bn` None (a convolution that no BatchNorm follows): its own weight,
    contiguous, and no bias."""
    if bn is None:
        return conv_module.weight.contiguous(), None
    s = bn.weight.double() / torch.sqrt(bn.running_var.double() + bn.eps)
    w = (conv_module.weight.double() * s.view(-1, 1, 1, 1)).float().contiguous()
    return w, bn.bias.double() - bn.running_mean.double() * s


class FrozenBNFold(nn.Module):
    """A module whose convolution + BatchNorm pairs fold into its forward
    when it is frozen: in eval mode, under no grad, with fp32 parameters and
    convolutions that compute in their own dtype (`Conv2d.compute_dtype`
    None). Anything else (training, grad, the bf16 policies) runs the
    unfolded forward as it is.

    `frozen_fold()` gives the folded state or None. The state is derived,
    never in `state_dict`: it is made at the first frozen forward, outside
    inference mode (its tensors are not inference tensors), and made anew
    when a source tensor changes in place (`load_state_dict`, an edit: its
    version counter moves) or the module is moved or cast (`.to()`,
    `cast_params`: `_apply`). A deep copy (`parallel.mesh.replicate`)
    carries its own sources and folds them anew on its device.

    Subclasses give `_fold_pairs()`, their (conv, bn) pairs (bn None for a
    convolution that no BatchNorm follows), and `_make_fold(folded)`, the
    forward's state from `fold_bn` of each pair.
    """

    _fold = None
    _fold_sources = ()
    _fold_versions = None
    _fold_convs = ()

    def frozen_fold(self):
        if self.training or torch.is_grad_enabled():
            return None
        if (self._fold is not None
                and [t._version for t in self._fold_sources] == self._fold_versions
                and all(c.compute_dtype is None for c in self._fold_convs)):
            return self._fold
        pairs = self._fold_pairs()
        convs = [c for c, _ in pairs]
        sources = [t for c, bn in pairs for t in (c.weight,) + (
            () if bn is None else (bn.weight, bn.bias, bn.running_mean, bn.running_var))]
        if (any(t.dtype != torch.float32 for t in sources)
                or any(c.compute_dtype is not None for c in convs)):
            return None
        with torch.inference_mode(False), torch.no_grad():
            fold = self._make_fold([fold_bn(c, bn) for c, bn in pairs])
        self._fold, self._fold_sources, self._fold_convs = fold, sources, convs
        self._fold_versions = [t._version for t in sources]
        return fold

    def _drop_fold(self):
        self._fold, self._fold_sources, self._fold_convs = None, (), ()

    def _apply(self, fn, *args, **kwargs):
        self._drop_fold()
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._drop_fold()  # `assign=True` replaces the tensors
        super()._load_from_state_dict(*args, **kwargs)


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
def synced_batch_norm(nets, group):
    """Inside the block the BatchNorms of `nets` take the global batch's
    moments over the ranks of `group` (None: nothing changes)."""
    bns = [m for net in nets for m in net.modules() if isinstance(m, BatchNorm2d)]
    saved = [m.sync_group for m in bns]
    for m in bns:
        m.sync_group = group
    try:
        yield
    finally:
        for m, g in zip(bns, saved):
            m.sync_group = g


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
