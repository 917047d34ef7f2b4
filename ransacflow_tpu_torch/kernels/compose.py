"""Kernel 8: the compose tail of the fine stage (`csrc/compose.cu`)."""

import ctypes

import torch

from ransacflow_tpu_torch.kernels.build import Kernel, check, forbid_grad, ptr, stream
from ransacflow_tpu_torch.ops.grid import normalized_grid
from ransacflow_tpu_torch.ops.sampler import grid_sample, interpolate_bilinear

KERNEL = Kernel("rf_compose_tail",
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def compose_tail_ref(flow_down8, match12_down8, match21_down8, flow_coarse,
                     cycle_match):
    """Plain PyTorch (`ransacflow_tpu/pipeline/fine.py:61-92`).

    flow_down8: (B, h8, w8, 2) residual flow; match12_down8, match21_down8:
    (B, h8, w8, 1); flow_coarse: (B, Ht, Wt, 2) coarse sampling grid. The
    residual is upsampled to Ht x Wt, added to the identity grid and
    clipped; flow12 is flow_coarse sampled there, match is the upsampled
    match12 (times the upsampled match21 sampled at the same point with
    cycle_match) where flow12 lies inside [-1, 1]^2, else 0.

    Returns (flow12 (B, Ht, Wt, 2), match (B, Ht, Wt)).
    """
    ht, wt = flow_coarse.shape[1:3]
    match12 = interpolate_bilinear(match12_down8, ht, wt)
    flow_up = interpolate_bilinear(flow_down8, ht, wt)
    grid = normalized_grid(ht, wt, flow_up.device, flow_up.dtype)[None]
    flow_up = (flow_up + grid).clamp(-1.0, 1.0)
    if cycle_match:
        # flow12 and the back-warped match21 sample the same grid: one call
        match21 = interpolate_bilinear(match21_down8, ht, wt)
        sampled = grid_sample(torch.cat([flow_coarse, match21], dim=-1), flow_up)
        flow12 = sampled[..., :2]
        match = match12 * sampled[..., 2:3]
    else:
        flow12 = grid_sample(flow_coarse, flow_up)
        match = match12
    in_bounds = ((flow12[..., 0:1] >= -1) & (flow12[..., 0:1] <= 1)
                 & (flow12[..., 1:2] >= -1) & (flow12[..., 1:2] <= 1))
    return flow12, (match * in_bounds.to(match.dtype))[..., 0]


def compose_tail(flow_down8, match12_down8, match21_down8, flow_coarse,
                 cycle_match):
    """`compose_tail_ref` for CPU tensors, the kernel for CUDA ones.
    Forward only: raises when an input requires grad under grad mode."""
    forbid_grad("compose_tail", flow_down8, match12_down8, match21_down8,
                flow_coarse)
    if flow_coarse.device.type == "cpu":
        return compose_tail_ref(flow_down8, match12_down8, match21_down8,
                                flow_coarse, cycle_match)
    dev = flow_coarse.device
    b, ht, wt = flow_coarse.shape[:3]
    h8, w8 = flow_down8.shape[1:3]
    check(flow_coarse, "flow_coarse", torch.float32, shape=(b, ht, wt, 2))
    check(flow_down8, "flow_down8", torch.float32, shape=(b, h8, w8, 2), device=dev)
    check(match12_down8, "match12_down8", torch.float32, shape=(b, h8, w8, 1), device=dev)
    check(match21_down8, "match21_down8", torch.float32, shape=(b, h8, w8, 1), device=dev)
    flow12 = torch.empty((b, ht, wt, 2), dtype=torch.float32, device=dev)
    match = torch.empty((b, ht, wt), dtype=torch.float32, device=dev)
    KERNEL(dev, ptr(flow_down8), ptr(match12_down8), ptr(match21_down8),
           ptr(flow_coarse), ptr(flow12), ptr(match), b, h8, w8, ht, wt,
           int(cycle_match), stream(flow_coarse))
    return flow12, match
