"""Kernel 8: the compose tail of the fine stage, a tiled kernel
(`csrc/compose.cu`)."""

import ctypes

import torch

from ransacflow_tpu_torch.kernels.build import (
    Kernel,
    check,
    forbid_grad,
    ptr,
    stream,
    upcast,
)
from ransacflow_tpu_torch.ops.grid import normalized_grid
from ransacflow_tpu_torch.ops.sampler import grid_sample, interpolate_bilinear

KERNEL = Kernel("rf_compose_tail",
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
# The kernel's tiling (`csrc/compose.cu`; the tests hold the two alike): a
# block per TILE_H x TILE_W output pixels; the stride-8 cells under a tile
# staged when they fit PATCH_H x PATCH_W, match21's with HALO_H rows and
# HALO_W columns more on each side.
TILE_H, TILE_W = 8, 64
PATCH_H, PATCH_W = 8, 24
HALO_H, HALO_W = 4, 8


def compose_tail_ref(flow_down8, match12_down8, match21_down8, flow_coarse,
                     cycle_match, out_hw=None):
    """Plain PyTorch (`ransacflow_tpu/pipeline/fine.py:46,61-92`).

    flow_down8: (B, h8, w8, 2) residual flow; match12_down8, match21_down8:
    (B, h8, w8, 1); flow_coarse: (B, Hc, Wc, 2) coarse sampling grid;
    out_hw: the output's (Ht, Wt), by default (Hc, Wc). The residual is
    upsampled to Ht x Wt, added to the identity grid and clipped; flow12 is
    flow_coarse sampled there, match is the upsampled match12 (times the
    upsampled match21 sampled at the same point with cycle_match) where
    flow12 lies inside [-1, 1]^2, else 0.

    Returns (flow12 (B, Ht, Wt, 2), match (B, Ht, Wt)).
    """
    ht, wt = out_hw if out_hw is not None else flow_coarse.shape[1:3]
    match12 = interpolate_bilinear(match12_down8, ht, wt)
    flow_up = interpolate_bilinear(flow_down8, ht, wt)
    grid = normalized_grid(ht, wt, flow_up.device, flow_up.dtype)[None]
    flow_up = (flow_up + grid).clamp(-1.0, 1.0)
    if cycle_match:
        match21 = interpolate_bilinear(match21_down8, ht, wt)
        if (ht, wt) == tuple(flow_coarse.shape[1:3]):
            # flow12 and the back-warped match21 sample the same grid: one call
            sampled = grid_sample(torch.cat([flow_coarse, match21], dim=-1), flow_up)
            flow12 = sampled[..., :2]
            match = match12 * sampled[..., 2:3]
        else:  # across resolutions: each map sampled at its own size
            flow12 = grid_sample(flow_coarse, flow_up)
            match = match12 * grid_sample(match21, flow_up)
    else:
        flow12 = grid_sample(flow_coarse, flow_up)
        match = match12
    in_bounds = ((flow12[..., 0:1] >= -1) & (flow12[..., 0:1] <= 1)
                 & (flow12[..., 1:2] >= -1) & (flow12[..., 1:2] <= 1))
    return flow12, (match * in_bounds.to(match.dtype))[..., 0]


def _out_dtypes(flow_coarse, match12, match21, cycle_match, same_size):
    """(flow12, match) dtypes of the reference's compose (`fine.py:69-92`):
    flow12 is flow_coarse sampled, with match21 in one concatenated map at
    one size; match is match12, times the sampled match21 with
    cycle_match."""
    promote = torch.promote_types
    flow = (promote(flow_coarse.dtype, match21.dtype) if cycle_match and same_size
            else flow_coarse.dtype)
    if not cycle_match:
        return flow, match12.dtype
    return flow, promote(match12.dtype, flow if same_size else match21.dtype)


def compose_tail(flow_down8, match12_down8, match21_down8, flow_coarse,
                 cycle_match, out_hw=None):
    """`compose_tail_ref` for CPU tensors, the kernel for CUDA ones.
    Forward only: raises when an input requires grad under grad mode.
    bf16 maps (the eval policy's heads) are upcast and the kernel composes
    in fp32 (the reference rounds its upsampled grid to bf16 there); each
    output is rounded to the reference's dtype (`_out_dtypes`)."""
    forbid_grad("compose_tail", flow_down8, match12_down8, match21_down8,
                flow_coarse)
    b, hc, wc = flow_coarse.shape[:3]
    ht, wt = out_hw if out_hw is not None else (hc, wc)
    flow_dtype, match_dtype = _out_dtypes(flow_coarse, match12_down8, match21_down8,
                                          cycle_match, (ht, wt) == (hc, wc))
    flow_down8, match12_down8, match21_down8, flow_coarse = upcast(
        flow_down8, match12_down8, match21_down8, flow_coarse)
    if flow_coarse.device.type == "cpu":
        flow12, match = compose_tail_ref(flow_down8, match12_down8, match21_down8,
                                         flow_coarse, cycle_match, out_hw)
        return flow12.to(flow_dtype), match.to(match_dtype)
    dev = flow_coarse.device
    h8, w8 = flow_down8.shape[1:3]
    check(flow_coarse, "flow_coarse", torch.float32, shape=(b, hc, wc, 2))
    check(flow_down8, "flow_down8", torch.float32, shape=(b, h8, w8, 2), device=dev)
    check(match12_down8, "match12_down8", torch.float32, shape=(b, h8, w8, 1), device=dev)
    check(match21_down8, "match21_down8", torch.float32, shape=(b, h8, w8, 1), device=dev)
    for name, x in (("flow_down8", flow_down8), ("flow_coarse", flow_coarse)):
        if ptr(x) % 8:  # read as float2
            raise ValueError(f"compose_tail: {name} must be 8-byte aligned")
    if b > 65535 or ht > 8 * 65535:
        raise ValueError("compose_tail: at most 65535 images and 524280 output rows")
    flow12 = torch.empty((b, ht, wt, 2), dtype=torch.float32, device=dev)
    match = torch.empty((b, ht, wt), dtype=torch.float32, device=dev)
    KERNEL(dev, ptr(flow_down8), ptr(match12_down8), ptr(match21_down8),
           ptr(flow_coarse), ptr(flow12), ptr(match), b, h8, w8, hc, wc, ht, wt,
           int(cycle_match), stream(flow_coarse))
    return flow12.to(flow_dtype), match.to(match_dtype)
