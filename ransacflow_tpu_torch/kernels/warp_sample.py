"""Kernel 5: the fine stage's source warp, bilinear sampling at a grid
(`csrc/warp_sample.cu`)."""

import ctypes

import torch

from ransacflow_tpu_torch.kernels.build import Kernel, check, ptr, stream
from ransacflow_tpu_torch.ops.sampler import grid_sample

KERNEL = Kernel("rf_warp_sample",
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def warp_sample_ref(image, grid):
    """Plain PyTorch: `F.grid_sample(align_corners=True, padding_mode=
    'zeros')` of (B, H, W, C) `image` at (B, Ho, Wo, 2) normalized (x, y)
    `grid`. Returns (B, Ho, Wo, C)."""
    return grid_sample(image, grid)


def warp_sample(image, grid):
    """`warp_sample_ref` for CPU tensors, the kernel for CUDA ones."""
    if image.device.type == "cpu":
        return warp_sample_ref(image, grid)
    check(image, "image", torch.float32, ndim=4)
    b, h, w, c = image.shape
    check(grid, "grid", torch.float32, ndim=4, device=image.device)
    if grid.shape[0] != b or grid.shape[3] != 2:
        raise ValueError(f"grid: shape {tuple(grid.shape)}, expected ({b}, Ho, Wo, 2)")
    if grid.data_ptr() % 8:
        raise ValueError("grid: must be 8-byte aligned (read as float2)")
    ho, wo = grid.shape[1:3]
    if max(image.numel(), grid.numel(), b * ho * wo * c) >= 2**31:
        raise ValueError("warp_sample: tensors must hold fewer than 2^31 elements")
    out = torch.empty((b, ho, wo, c), dtype=torch.float32, device=image.device)
    KERNEL(image.device, ptr(image), ptr(grid), ptr(out), b, h, w, c, ho, wo,
           stream(image))
    return out
