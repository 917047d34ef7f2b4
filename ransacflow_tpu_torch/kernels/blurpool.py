"""Kernel 9: blur-pool and its backward (`csrc/blurpool.cu`)."""

import ctypes
import math

import torch
import torch.nn.functional as F

from ransacflow_tpu_torch.kernels.build import Kernel, ptr, stream

KERNEL = Kernel("rf_blurpool_fwd",
                [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
KERNEL_BWD = Kernel("rf_blurpool_bwd",
                    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def binomial_filter(channels, filt_size, device=None):
    """(channels, 1, k, k) normalized binomial depthwise filter."""
    a = torch.tensor([math.comb(filt_size - 1, i) for i in range(filt_size)],
                     dtype=torch.float64)
    f = torch.outer(a, a)
    f = (f / f.sum()).float()
    return f.expand(channels, 1, -1, -1).contiguous().to(device)


def blur_pool_ref(x, filt, stride=2):
    """Plain PyTorch: reflect pad, then the depthwise `filt` (C, 1, k, k)
    with `stride`, on (N, C, H, W) `x`."""
    k = filt.shape[-1]
    lo, hi = (k - 1) // 2, -(-(k - 1) // 2)
    x = F.pad(x, (lo, hi, lo, hi), mode="reflect")
    return F.conv2d(x, filt, stride=stride, groups=x.shape[1])


def _layout(x, name):
    """1 for channels-last memory, 0 for NCHW; raises on any other view."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.dim() != 4:
        raise ValueError(f"{name}: expected a 4-d fp32 CUDA tensor")
    if x.is_contiguous():
        return 0
    if x.is_contiguous(memory_format=torch.channels_last):
        return 1
    raise ValueError(f"{name}: must be contiguous in NCHW or channels-last memory")


def _memory_format(channels_last):
    return torch.channels_last if channels_last else torch.contiguous_format


class _BlurPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        cl = _layout(x, "x")
        n, c, h, w = x.shape
        if min(h, w) < 2 or x.numel() >= 2**31:
            raise ValueError(f"blur_pool: shape {tuple(x.shape)} not supported")
        y = torch.empty((n, c, (h - 1) // 2 + 1, (w - 1) // 2 + 1), dtype=x.dtype,
                        device=x.device, memory_format=_memory_format(cl))
        KERNEL(x.device, ptr(x), ptr(y), n, c, h, w, cl, stream(x))
        ctx.shape, ctx.channels_last = tuple(x.shape), cl
        return y

    @staticmethod
    def backward(ctx, g):
        n, c, h, w = ctx.shape
        fmt = _memory_format(ctx.channels_last)
        g = g.contiguous(memory_format=fmt)
        dx = torch.empty(ctx.shape, dtype=g.dtype, device=g.device, memory_format=fmt)
        KERNEL_BWD(g.device, ptr(g), ptr(dx), n, c, h, w, ctx.channels_last, stream(g))
        return dx


def blur_pool(x, filt, stride=2):
    """`blur_pool_ref` for a CPU tensor. For a CUDA one, the kernel (the
    binomial-3 filter with stride 2 only), differentiable: its backward is
    a kernel too."""
    if x.device.type == "cpu":
        return blur_pool_ref(x, filt, stride)
    if filt.shape[-1] != 3 or stride != 2:
        raise ValueError("the blur-pool kernel takes filt_size 3 and stride 2 only")
    return _BlurPool.apply(x)
