"""Kernel 10: the masked SSIM reconstruction loss and its backward
(`csrc/ssim.cu`); port of `ransacflow_tpu/ops/ssim.py:57`.

11x11 Gaussian window (sigma 1.5), C1 = 0.01^2, C2 = 0.03^2; the mask is a
box-filtered matchability map thresholded at 0.5, so it has no gradient;
the loss is ``sum((1 - ssim_map) * mask) / sum(mask) / 3``.

When img1 needs a gradient, the forward kernel saves the per-pixel partials
of ``(1 - ssim_map) * mask`` with respect to mu1, G*x^2 and G*xy for the
backward, in a layout private to the pair: 9 planes (a of channels 0-2, then
b, then c), each `plane_len(B, H, W)` floats. `ssim_partials_ref` and
`masked_ssim_grad_ref` are the same algebra in plain PyTorch.
"""

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from ransacflow_tpu_torch.kernels.build import Kernel, check, library, ptr, stream

WINDOW, SIGMA = 11, 1.5
TILE_H, TILE_W = 32, 32  # kTileH, kTileW in the source: a tile of one image
N_PLANES = 9  # the saved partials: a, b, c (map-major), each for channels 0-2
C1, C2 = 0.01**2, 0.03**2
KERNEL = Kernel("rf_ssim_fwd",
                [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
                + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
KERNEL_BWD = Kernel("rf_ssim_bwd",
                    [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 3
                    + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_blocks = {}  # (symbol, device, B, H, W) -> the blocks a launch takes


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


def _moments(img1, img2, match):
    """The mask and the five blurred maps mu1, mu2, G*x^2, G*y^2, G*xy."""
    pad = WINDOW // 2
    g = gaussian_window()
    mask = _sep_conv(match, np.full((WINDOW,), BOX_TAP, np.float32), pad) + 1e-7
    mask = (mask > 0.5).to(img1.dtype) + 1e-7
    return (mask, _sep_conv(img1, g, pad), _sep_conv(img2, g, pad),
            _sep_conv(img1 * img1, g, pad), _sep_conv(img2 * img2, g, pad),
            _sep_conv(img1 * img2, g, pad))


def masked_ssim_loss_ref(img1, img2, match):
    """Plain PyTorch (the separable grouped `F.conv2d` form), with its own
    autograd. img1, img2: (B, H, W, 3); match: (B, H, W, 1)."""
    mask, mu1, mu2, e11, e22, e12 = _moments(img1, img2, match)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq, sigma2_sq, sigma12 = e11 - mu1_sq, e22 - mu2_sq, e12 - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return ((1.0 - ssim_map) * mask).sum() / mask.sum() / 3.0


def ssim_partials_ref(img1, img2, match):
    """What the forward kernel saves for the backward, in plain PyTorch: the
    partials of (1 - S) * mask with respect to mu1, G*x^2 and G*xy as
    (9, B, H, W) planes (a of channels 0-2, then b, then c), and
    sum(mask)."""
    mask, mu1, mu2, e11, e22, e12 = _moments(img1, img2, match)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    a1, a2 = 2 * mu1_mu2 + C1, 2 * (e12 - mu1_mu2) + C2
    b1, b2 = mu1_sq + mu2_sq + C1, (e11 - mu1_sq) + (e22 - mu2_sq) + C2
    ssim = (a1 * a2) / (b1 * b2)
    inv = 1 / (b1 * b2)  # 1 / b1 - 1 / b2 = (b2 - b1) inv, 1 / b2 = b1 inv
    d_mu1 = (2 * mu2 * (a2 - a1) - 2 * mu1 * ssim * (b2 - b1)) * inv
    abc = torch.cat([-mask * d_mu1, mask * (ssim * b1 * inv), -mask * (2 * a1 * inv)], dim=-1)
    return abc.permute(3, 0, 1, 2), mask.sum()


def masked_ssim_grad_ref(img1, img2, abc, mask_sum, g):
    """The backward kernel's closed form in plain PyTorch: d_img1 =
    g / (3 sum(mask)) * (G*a + 2 x G*b + y G*c), from the (9, B, H, W)
    planes of `ssim_partials_ref` blurred by the Gaussian (self-adjoint
    under zero "same" padding)."""
    blurred = _sep_conv(abc.permute(1, 2, 3, 0), gaussian_window(), WINDOW // 2)
    ga, gb, gc = blurred[..., 0:3], blurred[..., 3:6], blurred[..., 6:9]
    return g / (3 * mask_sum) * (ga + 2 * img1 * gb + img2 * gc)


def plane_len(b, h, w):
    """Floats in one plane of the saved partials: B H W rounded up to a
    multiple of 4, so that every plane's rows align alike."""
    return -(-(b * h * w) // 4) * 4


def _n_blocks(symbol, device, b, h, w):
    """The blocks of one launch of the persistent kernel behind `symbol`
    (`rf_ssim_fwd_blocks`, `rf_ssim_bwd_blocks`): as many as the device
    holds at once, at most one per tile. Asked once per device and shape."""
    key = (symbol, device, b, h, w)
    if key not in _blocks:
        fn = getattr(library(), symbol)
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        n = ctypes.c_int()
        with torch.cuda.device(device):
            err = fn(b, h, w, ctypes.byref(n))
        if err != 0:
            raise RuntimeError(f"{symbol}: CUDA error {err}: "
                               f"{library().rf_error_string(err).decode()}")
        _blocks[key] = n.value
    return _blocks[key]


def _aligned(t):
    """`t`, or a copy when its data do not start on 16 bytes (the kernels
    copy and store 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def masked_ssim_forward(img1, img2, match, partials):
    """K10 on CUDA tensors: (loss, sums, abc), sums = (sum((1 - S) * mask),
    sum(mask)) and abc the saved partials' 9 planes, flat, `plane_len`
    floats each, when `partials`, else None."""
    check(img1, "img1", torch.float32, ndim=4)
    b, h, w, c = img1.shape
    if c != 3:
        raise ValueError(f"img1: {c} channels, expected 3")
    check(img2, "img2", torch.float32, shape=img1.shape, device=img1.device)
    check(match, "match", torch.float32, shape=(b, h, w, 1), device=img1.device)
    if img1.numel() * 3 >= 2**31:
        raise ValueError("masked_ssim_loss: tensors must hold fewer than 2^31 / 3 elements")
    img1, img2, match = _aligned(img1), _aligned(img2), _aligned(match)
    dev = img1.device
    n_blocks = _n_blocks("rf_ssim_fwd_blocks", dev, b, h, w)
    block_sums = torch.empty(2 * n_blocks, device=dev)
    plane = plane_len(b, h, w)
    abc = torch.empty(N_PLANES * plane, device=dev) if partials else None
    sums = torch.empty(2, device=dev)
    loss = torch.empty((), device=dev)
    KERNEL(dev, ptr(img1), ptr(img2), ptr(match), ptr(block_sums), n_blocks,
           ctypes.c_void_p(None if abc is None else abc.data_ptr()), plane,
           ptr(sums), ptr(loss), b, h, w, stream(img1))
    return loss, sums, abc


class _MaskedSSIM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img1, img2, match):
        loss, sums, abc = masked_ssim_forward(img1, img2, match, ctx.needs_input_grad[0])
        if abc is not None:
            ctx.save_for_backward(img1, img2, abc, sums)
        return loss

    @staticmethod
    def backward(ctx, g):
        img1, img2, abc, sums = ctx.saved_tensors
        img1, img2 = _aligned(img1), _aligned(img2)
        b, h, w, _ = img1.shape
        g = g.contiguous()
        d_img1 = torch.empty_like(img1)
        KERNEL_BWD(img1.device, ptr(img1), ptr(img2), ptr(abc), plane_len(b, h, w),
                   ptr(sums), ptr(g), ptr(d_img1),
                   _n_blocks("rf_ssim_bwd_blocks", img1.device, b, h, w), b, h, w,
                   stream(img1))
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
