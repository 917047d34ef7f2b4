"""Flow and matchability heads over the local correlation volume, port of
`ransacflow_tpu/models/heads.py:56-142`.

Both heads share one trunk shape: conv3x3 k^2 -> 512 -> 256 -> 128 with BN
and ReLU between, then conv3x3 to k^2 (flow: softmax expectation over the
offsets) or to 1 (matchability: sigmoid). All convs are bias-free and run
on cuDNN, but in a frozen head (eval mode, no grad, fp32:
`layers.FrozenBNFold`), whose BatchNorm folds into conv1-3 and whose four
convolutions run in NHWC as launches of kernel 15 (`kernels/fine_conv`),
conv1-3 with bias and ReLU, conv4 a plain store. The epilogues after conv4
are kernel 7 (`kernels/heads.py`), whose backward is a kernel too.
`net_flow_coarse` and `net_matchability` run a
head with its epilogue (the training path); the fine stage runs its three
trunks (`head_logits`) and then one launch for the three epilogues
(`kernels/heads.head_epilogues`). `pred_flow_coarse`,
`pred_flow_coarse_no_grad` and `pred_matchability` are the reference's
API names over the first two.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ransacflow_tpu_torch.kernels.fine_conv import fine_conv, pack_folded
from ransacflow_tpu_torch.kernels.heads import flow_epilogue, match_epilogue
from ransacflow_tpu_torch.models.layers import BatchNorm2d, FrozenBNFold, conv, nchw, nhwc
from ransacflow_tpu_torch.ops.sampler import upsample_bilinear_x8

TRUNK = (512, 256, 128)


class Head(FrozenBNFold):
    def __init__(self, kernel_size, out_ch):
        super().__init__()
        widths = (kernel_size * kernel_size,) + TRUNK
        for i in range(3):
            setattr(self, f"conv{i + 1}", conv(widths[i], widths[i + 1], 3, 1, 1))
            setattr(self, f"bn{i + 1}", BatchNorm2d(widths[i + 1]))
        self.conv4 = conv(TRUNK[-1], out_ch, 3, 1, 1)

    def _fold_pairs(self):
        return [(self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3),
                (self.conv4, None)]

    def _make_fold(self, folded):
        convs = (self.conv1, self.conv2, self.conv3, self.conv4)
        return tuple(pack_folded(c, w, b) for c, (w, b) in zip(convs, folded))

    def forward(self, x):
        fold = self.frozen_fold()
        if fold is not None:  # NHWC in and out, as NCHW views of channels-last memory
            x = nhwc(x)
            for pc in fold:
                x = fine_conv(x, pc)
            return nchw(x)
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return self.conv4(x)


def head_logits(net, corr):
    """(B, H, W, k^2) correlation -> conv4's (B, H, W, C) logits of a head.
    The convolutions run channels-last (`nchw` of an NHWC tensor is a
    channels-last view; a frozen head computes in NHWC), so `nhwc` of
    conv4's output is a view too."""
    return nhwc(net(nchw(corr)))


def net_flow_coarse(net, corr, up8=True, kernel_size=7):
    """(B, H, W, k^2) correlation -> (B, H, W, 2) normalized residual flow
    (x then y), or (B, 8H, 8W, 2) with up8: the softmax expectation over the
    k x k offset grid, divided by the feature width/height, times 2."""
    flow = flow_epilogue(head_logits(net, corr), kernel_size)
    return upsample_bilinear_x8(flow) if up8 else flow


def net_matchability(net, corr, up8=True):
    """(B, H, W, k^2) correlation -> (B, H, W, 1) matchability in (0, 1),
    or (B, 8H, 8W, 1) with up8."""
    m = match_epilogue(head_logits(net, corr))
    return upsample_bilinear_x8(m) if up8 else m


def pred_flow_coarse(net, corr, grid, up8=True, kernel_size=7):
    """The reference's ``predFlowCoarse`` (model/model.py:331-340): the flow
    head, then (its diagonal gradient magnitude (B, H-1, W-1, 1), the
    absolute sampling grid `flow_to_grid(flow, grid)`). Differentiable: on
    the card the epilogue and its backward are kernel 7's.

    The JAX function also returns the BatchNorm statistics of a train-mode
    call; here they are the module's buffers, which `net.train()` updates
    in place, so there is no third output.
    """
    flow = net_flow_coarse(net, corr, up8, kernel_size)
    return flow_gradient_magnitude(flow), flow_to_grid(flow, grid)


def pred_flow_coarse_no_grad(net, corr, grid, up8=True, kernel_size=7):
    """The reference's ``predFlowCoarseNoGrad`` (model/model.py:342-350):
    the absolute sampling grid alone, under `torch.no_grad()`."""
    with torch.no_grad():
        return flow_to_grid(net_flow_coarse(net, corr, up8, kernel_size), grid)


def pred_matchability(net, corr, up8=True):
    """The reference's ``predMatchability`` (model/model.py:353-357):
    `net_matchability`. As in `pred_flow_coarse`, a train-mode call updates
    the module's BatchNorm buffers in place of JAX's returned statistics."""
    return net_matchability(net, corr, up8)


def flow_gradient_magnitude(flow):
    """Diagonal forward-difference magnitude of a (B, H, W, 2) flow field,
    ``|flow[1:, 1:] - flow[:-1, :-1]|_2`` over the 2 channels. Returns
    (B, H-1, W-1, 1). The 1e-24 floor keeps the gradient finite where the
    difference is exactly 0, as the reference's safe norm does."""
    d = flow[:, 1:, 1:, :] - flow[:, :-1, :-1, :]
    return torch.sqrt((d * d).sum(dim=-1, keepdim=True).clamp_min(1e-24))


def flow_to_grid(flow, grid):
    """Absolute sampling grid: flow + grid clipped to [-1, 1]. Written as
    min(max(x, -1), 1) and not `torch.clamp`: at an exact tie with +-1 (the
    identity grid's border) both give the gradient 0.5, as `jnp.clip` does;
    `torch.clamp` gives 1."""
    x = flow + grid
    return torch.minimum(torch.maximum(x, torch.full((), -1.0, dtype=x.dtype,
                                                     device=x.device)),
                         torch.full((), 1.0, dtype=x.dtype, device=x.device))
