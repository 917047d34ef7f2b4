"""Kernel 13: the PPM adaptive average pools of the sky-mask network, every
scale from one read of the map (`csrc/adaptive_pool.cu`)."""

import ctypes

import numpy as np
import torch

from ransacflow_tpu_torch.kernels.build import Kernel, check, forbid_grad, ptr, stream

KERNEL = Kernel("rf_ppm_pool",
                [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
                + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
_plans = {}  # (H, W, scales, device) -> (plan int32 on the device, n_row_segs, n_col_segs)


def bin_edges(size, s):
    """torch `AdaptiveAvgPool2d` bins of one axis: bin i of s spans
    [floor(i * size / s), ceil((i + 1) * size / s))."""
    return [((i * size) // s, -(-((i + 1) * size) // s)) for i in range(s)]


def segment_plan(H, W, scales=(1, 2, 3, 6)):
    """The segment cells that every bin of every scale is a rectangle of.

    Returns (row_edges, col_edges, bins): the sorted union of the bins'
    edges on each axis, so that segment k of an axis spans [edges[k],
    edges[k + 1]), and for each bin, scale by scale in row-major order, its
    segment ranges (rs0, rs1, cs0, cs1): rows [row_edges[rs0],
    row_edges[rs1]) and columns [col_edges[cs0], col_edges[cs1]).
    """
    axes = []
    for size in (H, W):
        edges = sorted({e for s in scales for bin_ in bin_edges(size, s) for e in bin_})
        axes.append((edges, {e: k for k, e in enumerate(edges)}))
    (row_edges, ri), (col_edges, ci) = axes
    bins = [(ri[r0], ri[r1], ci[c0], ci[c1]) for s in scales
            for r0, r1 in bin_edges(H, s) for c0, c1 in bin_edges(W, s)]
    return row_edges, col_edges, bins


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


def _plan_on_device(H, W, scales, device):
    key = (H, W, tuple(scales), device)
    if key not in _plans:
        row_edges, col_edges, bins = segment_plan(H, W, scales)
        flat = np.concatenate([row_edges, col_edges, np.ravel(bins)]).astype(np.int32)
        _plans[key] = (torch.from_numpy(flat).to(device), len(row_edges) - 1,
                       len(col_edges) - 1)
    return _plans[key]


def ppm_pool(x, scales=(1, 2, 3, 6)):
    """`ppm_pool_ref` for a CPU tensor; for a CUDA one, one call of the
    kernel pools every bin of every scale (two device kernels: the segment
    cells' sums from one read of `x`, then the bins). Forward only."""
    forbid_grad("ppm_pool", x)
    if x.device.type == "cpu":
        return ppm_pool_ref(x, scales)
    check(x, "x", torch.float32, ndim=4)
    B, H, W, C = x.shape
    if x.numel() >= 2**31:
        raise ValueError("ppm_pool: x must hold fewer than 2^31 elements")
    if B > 65535:
        raise ValueError("ppm_pool: at most 65535 images a call")
    plan, n_row_segs, n_col_segs = _plan_on_device(H, W, scales, x.device)
    n_bins = sum(s * s for s in scales)
    cells = torch.empty((B, n_row_segs * n_col_segs, C), dtype=torch.float32, device=x.device)
    out = torch.empty((B, n_bins, C), dtype=torch.float32, device=x.device)
    KERNEL(x.device, ptr(x), B, H, W, C, ptr(plan), n_row_segs, n_col_segs, n_bins,
           ptr(cells), ptr(out), stream(x))
    pooled, offset = [], 0
    for s in scales:
        pooled.append(out[:, offset:offset + s * s].view(B, s, s, C))
        offset += s * s
    return tuple(pooled)
