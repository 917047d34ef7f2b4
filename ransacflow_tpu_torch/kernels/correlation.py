"""Kernel 6: local correlation volume, its pair form and its backward
(`csrc/correlation.cu`)."""

import ctypes

import torch
import torch.nn.functional as F

from ransacflow_tpu_torch.kernels.build import (
    Kernel,
    check,
    forbid_grad,
    ptr,
    stream,
    upcast,
)

MAX_KERNEL_SIZE = 11  # the source's kernels are instantiated for odd k up to 11

KERNEL = Kernel("rf_correlation_volume",
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
KERNEL_PAIR = Kernel("rf_correlation_pair",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
KERNEL_BWD = Kernel("rf_correlation_volume_bwd",
                    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def correlation_volume_ref(x, y, kernel_size=7):
    """Plain PyTorch: ``corr[b, i, j, di*k+dj] = sum_c x[b,i,j,c] *
    y[b, i+di-p, j+dj-p, c]``, p = k//2, zeros outside the map."""
    p = kernel_size // 2
    _, h, w, _ = x.shape
    y_pad = F.pad(y, (0, 0, p, p, p, p))
    return torch.stack([(x * y_pad[:, di:di + h, dj:dj + w, :]).sum(-1)
                        for di in range(kernel_size)
                        for dj in range(kernel_size)], dim=-1)


def correlation_pair_ref(x, y, kernel_size=7):
    """Plain PyTorch: (corr(x, y), corr(y, x)), the second from the first by
    the identity ``corr(y, x)[b, i, j, (di, dj)] = corr(x, y)[b, i+di-p,
    j+dj-p, (2p-di, 2p-dj)]`` (k - 1 = 2p), zeros where (i+di-p, j+dj-p)
    lies outside the map."""
    k, p = kernel_size, kernel_size // 2
    _, h, w, _ = x.shape
    xy = correlation_volume_ref(x, y, k)
    pad = F.pad(xy, (0, 0, p, p, p, p))
    kk = k * k
    yx = torch.stack([pad[:, di:di + h, dj:dj + w, kk - 1 - (di * k + dj)]
                      for di in range(k) for dj in range(k)], dim=-1)
    return xy, yx


def _check_kernel_size(kernel_size):
    if kernel_size % 2 == 0 or not 1 <= kernel_size <= MAX_KERNEL_SIZE:
        raise ValueError(f"kernel_size must be odd and <= {MAX_KERNEL_SIZE}")


def correlation_pair(x, y, kernel_size=7):
    """(B, H, W, C) x, y -> (corr(x, y), corr(y, x)), each (B, H, W, k*k):
    the fine stage's two volumes. A CPU tensor takes the plain version; a
    CUDA one launches one kernel that writes both (each value of corr(x, y)
    also to its place in corr(y, x)), equal bit for bit to two
    `correlation_volume` launches. Forward only. bf16 features (the eval
    policy) are upcast and the volumes rounded to bf16, the reference's
    dtype."""
    forbid_grad("correlation_pair", x, y)
    dtype = torch.promote_types(x.dtype, y.dtype)
    x, y = upcast(x, y)
    if x.device.type == "cpu":
        return tuple(v.to(dtype) for v in correlation_pair_ref(x, y, kernel_size))
    _check_kernel_size(kernel_size)
    check(x, "x", torch.float32, ndim=4)
    check(y, "y", torch.float32, shape=x.shape, device=x.device)
    b, h, w, c = x.shape
    xy, yx = torch.empty((2, b, h, w, kernel_size * kernel_size), dtype=x.dtype,
                         device=x.device)
    KERNEL_PAIR(x.device, ptr(x), ptr(y), ptr(xy), ptr(yx), b, h, w, c, kernel_size,
                stream(x))
    return xy.to(dtype), yx.to(dtype)


class _Correlation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, kernel_size):
        check(x, "x", torch.float32, ndim=4)
        check(y, "y", torch.float32, shape=x.shape, device=x.device)
        b, h, w, c = x.shape
        out = torch.empty((b, h, w, kernel_size * kernel_size), dtype=x.dtype,
                          device=x.device)
        KERNEL(x.device, ptr(x), ptr(y), ptr(out), b, h, w, c, kernel_size, stream(x))
        ctx.save_for_backward(x, y)
        ctx.kernel_size = kernel_size
        return out

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        g = g.contiguous()
        need_x, need_y = ctx.needs_input_grad[:2]
        dx = torch.empty_like(x) if need_x else None
        dy = torch.empty_like(y) if need_y else None
        if need_x or need_y:
            b, h, w, c = x.shape
            null = ctypes.c_void_p(None)
            KERNEL_BWD(x.device, ptr(x), ptr(y), ptr(g),
                       ptr(dx) if need_x else null, ptr(dy) if need_y else null,
                       b, h, w, c, ctx.kernel_size, stream(x))
        return dx, dy, None


def correlation_volume(x, y, kernel_size=7):
    """(B, H, W, C) x, y -> (B, H, W, k*k) local correlation.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
    differentiable in x and y: the backward is a kernel too. bf16 inputs are
    upcast and the volume rounded to bf16; their cotangents come back in
    bf16.
    """
    dtype = torch.promote_types(x.dtype, y.dtype)
    x, y = upcast(x, y)
    if x.device.type == "cpu":
        return correlation_volume_ref(x, y, kernel_size).to(dtype)
    _check_kernel_size(kernel_size)
    return _Correlation.apply(x, y, kernel_size).to(dtype)
