"""Kernel 10: the masked SSIM reconstruction loss and its backward
(`csrc/ssim.cu`); port of `ransacflow_tpu/ops/ssim.py:57`.

11x11 Gaussian window (sigma 1.5), C1 = 0.01^2, C2 = 0.03^2; the mask is a
box-filtered matchability map thresholded at 0.5, so it has no gradient;
the loss is ``sum((1 - ssim_map) * mask) / sum(mask) / 3``.
"""

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from ransacflow_tpu_torch.kernels.build import Kernel, check, ptr, stream

WINDOW, SIGMA = 11, 1.5
TILE_H, TILE_W = 16, 32  # kTileH, kTileW in the source: one block's pixels
KERNEL = Kernel("rf_ssim_fwd",
                [ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_void_p] * 4
                + [ctypes.c_int] * 3 + [ctypes.c_void_p])
KERNEL_BWD = Kernel("rf_ssim_bwd",
                    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_gauss = {}  # device -> the 11 taps on it


def gaussian_window(window_size=WINDOW, sigma=SIGMA):
    """Normalized 1-D Gaussian at integer taps, fp32, as the reference
    computes it."""
    g = np.array([math.exp(-((i - window_size // 2) ** 2) / (2.0 * sigma**2))
                  for i in range(window_size)], dtype=np.float32)
    return g / g.sum()


BOX_TAP = np.float32(1.0 / WINDOW)


def _sep_conv(x, taps, pad):
    """Separable depthwise 2-D conv with zero padding, rows then columns, of
    (B, H, W, C) `x` with the 1-D `taps`."""
    c = x.shape[-1]
    k = torch.from_numpy(taps).to(x.device)
    x = x.permute(0, 3, 1, 2)
    x = F.conv2d(x, k.view(1, 1, -1, 1).expand(c, 1, -1, 1), padding=(pad, 0), groups=c)
    x = F.conv2d(x, k.view(1, 1, 1, -1).expand(c, 1, 1, -1), padding=(0, pad), groups=c)
    return x.permute(0, 2, 3, 1)


def masked_ssim_loss_ref(img1, img2, match):
    """Plain PyTorch (the separable grouped `F.conv2d` form), with its own
    autograd. img1, img2: (B, H, W, 3); match: (B, H, W, 1)."""
    pad = WINDOW // 2
    g = gaussian_window()
    box = np.full((WINDOW,), BOX_TAP, np.float32)
    mask = _sep_conv(match, box, pad) + 1e-7
    mask = (mask > 0.5).to(img1.dtype) + 1e-7
    mu1, mu2 = _sep_conv(img1, g, pad), _sep_conv(img2, g, pad)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _sep_conv(img1 * img1, g, pad) - mu1_sq
    sigma2_sq = _sep_conv(img2 * img2, g, pad) - mu2_sq
    sigma12 = _sep_conv(img1 * img2, g, pad) - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ((1.0 - ssim_map) * mask).sum() / mask.sum() / 3.0


def _taps_on(device):
    if device not in _gauss:
        _gauss[device] = torch.from_numpy(gaussian_window()).to(device)
    return _gauss[device]


class _MaskedSSIM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img1, img2, match):
        check(img1, "img1", torch.float32, ndim=4)
        b, h, w, c = img1.shape
        if c != 3:
            raise ValueError(f"img1: {c} channels, expected 3")
        check(img2, "img2", torch.float32, shape=img1.shape, device=img1.device)
        check(match, "match", torch.float32, shape=(b, h, w, 1), device=img1.device)
        if img1.numel() * 3 >= 2**31:
            raise ValueError("masked_ssim_loss: tensors must hold fewer than 2^31 / 3 elements")
        dev = img1.device
        gauss = _taps_on(dev)
        n_blocks = -(-h // TILE_H) * -(-w // TILE_W) * b
        partials = torch.empty(2 * n_blocks, device=dev)
        abc = (torch.empty((3, b, h, w, 3), device=dev) if ctx.needs_input_grad[0]
               else None)
        sums = torch.empty(2, device=dev)  # sum((1 - ssim) * mask), sum(mask)
        loss = torch.empty((), device=dev)
        KERNEL(dev, ptr(img1), ptr(img2), ptr(match), ptr(gauss), float(BOX_TAP),
               ptr(partials), ctypes.c_void_p(None if abc is None else abc.data_ptr()),
               ptr(sums), ptr(loss), b, h, w, stream(img1))
        if abc is not None:
            ctx.save_for_backward(img1, img2, abc, sums)
        return loss

    @staticmethod
    def backward(ctx, g):
        img1, img2, abc, sums = ctx.saved_tensors
        b, h, w, _ = img1.shape
        g = g.contiguous()
        d_img1 = torch.empty_like(img1)
        KERNEL_BWD(img1.device, ptr(img1), ptr(img2), ptr(abc), ptr(_taps_on(img1.device)),
                   ptr(sums), ptr(g), ptr(d_img1), b, h, w, stream(img1))
        return d_img1, None, None


def masked_ssim_loss(img1, img2, match):
    """SSIM dissimilarity of (B, H, W, 3) img1 and img2 under the mask of
    (B, H, W, 1) matchability `match`: `masked_ssim_loss_ref` for CPU
    tensors; for CUDA ones the kernel, differentiable in img1 only (img2 is
    data and the thresholded mask has zero gradient); raises when img2
    requires grad."""
    if img1.device.type == "cpu":
        return masked_ssim_loss_ref(img1, img2, match)
    if torch.is_grad_enabled() and img2.requires_grad:
        raise RuntimeError("masked_ssim_loss: the kernel has no gradient for img2")
    return _MaskedSSIM.apply(img1, img2, match)
