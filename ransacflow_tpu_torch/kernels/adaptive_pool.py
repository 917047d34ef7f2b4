"""Kernel 13: the PPM adaptive average pools of the sky-mask network, every
scale in one launch (`csrc/adaptive_pool.cu`)."""

import ctypes

import numpy as np
import torch

from ransacflow_tpu_torch.kernels.build import Kernel, check, forbid_grad, ptr, stream

KERNEL = Kernel("rf_ppm_pool",
                [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
                + [ctypes.c_int] + [ctypes.c_void_p] * 2)
_bins = {}  # (H, W, scales, device) -> (n_bins, 4) int32 on the device


def bin_edges(size, s):
    """torch `AdaptiveAvgPool2d` bins of one axis: bin i of s spans
    [floor(i * size / s), ceil((i + 1) * size / s))."""
    return [((i * size) // s, -(-((i + 1) * size) // s)) for i in range(s)]


def ppm_pool_ref(x, scales=(1, 2, 3, 6)):
    """Plain PyTorch: the mean of each bin's slice of (B, H, W, C) `x`, as
    `ransacflow_tpu/models/segnet.py:151-160` takes it. Returns one
    (B, s, s, C) tensor per scale."""
    _, H, W, _ = x.shape
    return tuple(
        torch.stack([torch.stack([x[:, r0:r1, c0:c1, :].mean(dim=(1, 2))
                                  for c0, c1 in bin_edges(W, s)], dim=1)
                     for r0, r1 in bin_edges(H, s)], dim=1)
        for s in scales)


def _bins_on_device(H, W, scales, device):
    key = (H, W, tuple(scales), device)
    if key not in _bins:
        rows = [(r0, r1, c0, c1) for s in scales
                for r0, r1 in bin_edges(H, s) for c0, c1 in bin_edges(W, s)]
        _bins[key] = torch.from_numpy(np.array(rows, np.int32)).to(device)
    return _bins[key]


def ppm_pool(x, scales=(1, 2, 3, 6)):
    """`ppm_pool_ref` for a CPU tensor; for a CUDA one, the kernel pools
    every bin of every scale in one launch. Forward only."""
    forbid_grad("ppm_pool", x)
    if x.device.type == "cpu":
        return ppm_pool_ref(x, scales)
    check(x, "x", torch.float32, ndim=4)
    B, H, W, C = x.shape
    if x.numel() >= 2**31:
        raise ValueError("ppm_pool: x must hold fewer than 2^31 elements")
    bins = _bins_on_device(H, W, scales, x.device)
    n_bins = bins.shape[0]
    out = torch.empty((B, n_bins, C), dtype=torch.float32, device=x.device)
    KERNEL(x.device, ptr(x), B, H, W, C, ptr(bins), n_bins, ptr(out), stream(x))
    pooled, offset = [], 0
    for s in scales:
        pooled.append(out[:, offset:offset + s * s].view(B, s, s, C))
        offset += s * s
    return tuple(pooled)
