"""Kernel 6: local correlation volume (`csrc/correlation.cu`)."""

import ctypes

import torch
import torch.nn.functional as F

from ransacflow_tpu_torch.kernels.build import Kernel, check, ptr, stream

MAX_KERNEL_SIZE = 11  # kTileJ * k * k <= kThreads * kMaxAcc in the source

KERNEL = Kernel("rf_correlation_volume",
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def correlation_volume_ref(x, y, kernel_size=7):
    """Plain PyTorch: ``corr[b, i, j, di*k+dj] = sum_c x[b,i,j,c] *
    y[b, i+di-p, j+dj-p, c]``, p = k//2, zeros outside the map."""
    p = kernel_size // 2
    _, h, w, _ = x.shape
    y_pad = F.pad(y, (0, 0, p, p, p, p))
    return torch.stack([(x * y_pad[:, di:di + h, dj:dj + w, :]).sum(-1)
                        for di in range(kernel_size)
                        for dj in range(kernel_size)], dim=-1)


def correlation_volume(x, y, kernel_size=7):
    """(B, H, W, C) fp32 x, y -> (B, H, W, k*k) local correlation.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if x.device.type == "cpu":
        return correlation_volume_ref(x, y, kernel_size)
    if kernel_size % 2 == 0 or not 1 <= kernel_size <= MAX_KERNEL_SIZE:
        raise ValueError(f"kernel_size must be odd and <= {MAX_KERNEL_SIZE}")
    check(x, "x", torch.float32, ndim=4)
    check(y, "y", torch.float32, shape=x.shape, device=x.device)
    b, h, w, c = x.shape
    out = torch.empty((b, h, w, kernel_size * kernel_size), dtype=x.dtype,
                      device=x.device)
    KERNEL(x.device, ptr(x), ptr(y), ptr(out), b, h, w, c, kernel_size, stream(x))
    return out
