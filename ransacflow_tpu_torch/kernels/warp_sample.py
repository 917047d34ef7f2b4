"""Kernel 5, bilinear sampling at a grid (`csrc/warp_sample.cu`), and its
backward, kernel 11 (`csrc/grid_sample_bwd.cu`): the fine stage's source
warp and the differentiable `grid_sample` of the training losses."""

import ctypes

import torch

from ransacflow_tpu_torch.kernels.build import Kernel, check, ptr, stream
from ransacflow_tpu_torch.ops.sampler import grid_sample

KERNEL = Kernel("rf_warp_sample",
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
KERNEL_BWD = Kernel("rf_grid_sample_bwd",
                    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def warp_sample_ref(image, grid):
    """Plain PyTorch: `F.grid_sample(align_corners=True, padding_mode=
    'zeros')` of (B, H, W, C) `image` at (B, Ho, Wo, 2) normalized (x, y)
    `grid`, with its own autograd. Returns (B, Ho, Wo, C)."""
    return grid_sample(image, grid)


def _check(image, grid):
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
    return b, h, w, c, ho, wo


class _WarpSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, image, grid):
        b, h, w, c, ho, wo = _check(image, grid)
        out = torch.empty((b, ho, wo, c), dtype=torch.float32, device=image.device)
        KERNEL(image.device, ptr(image), ptr(grid), ptr(out), b, h, w, c, ho, wo,
               stream(image))
        ctx.save_for_backward(image, grid)
        return out

    @staticmethod
    def backward(ctx, g):
        image, grid = ctx.saved_tensors
        b, h, w, c = image.shape
        ho, wo = grid.shape[1:3]
        g = g.contiguous()
        # the splat only when the image needs a cotangent
        d_image = torch.zeros_like(image) if ctx.needs_input_grad[0] else None
        d_grid = torch.empty_like(grid)
        KERNEL_BWD(image.device, ptr(image), ptr(grid), ptr(g),
                   ctypes.c_void_p(None if d_image is None else d_image.data_ptr()),
                   ptr(d_grid), b, h, w, c, ho, wo, stream(image))
        return d_image, (d_grid if ctx.needs_input_grad[1] else None)


def warp_sample(image, grid):
    """`warp_sample_ref` for CPU tensors. For CUDA ones, kernel 5,
    differentiable in both inputs: the backward is kernel 11."""
    if image.device.type == "cpu":
        return warp_sample_ref(image, grid)
    return _WarpSample.apply(image, grid)
