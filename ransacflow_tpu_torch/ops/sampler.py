"""Bilinear sampling, resizing and affine grids, channels-last, forward only.

Port of `ransacflow_tpu/ops/sampler.py:240-325`. PyTorch's own operators
carry the semantics: `grid_sample` is `F.grid_sample(align_corners=True,
padding_mode='zeros')` and `interpolate_bilinear` is `F.interpolate(mode=
'bilinear')`. The reference's TPU gather workarounds have no counterpart.
"""

import torch
import torch.nn.functional as F


def grid_sample(image, grid, align_corners=True):
    """Bilinear sample (B, H, W, C) `image` at (B, Ho, Wo, 2) normalized
    (x, y) `grid`, zeros outside. Returns (B, Ho, Wo, C)."""
    out = F.grid_sample(image.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=align_corners)
    return out.permute(0, 2, 3, 1)


def interpolate_bilinear(x, out_h, out_w, align_corners=False):
    """``F.interpolate(x, (out_h, out_w), mode='bilinear')`` on (B, H, W, C)."""
    out = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w),
                        mode="bilinear", align_corners=align_corners)
    return out.permute(0, 2, 3, 1)


def upsample_bilinear_x8(x):
    """``F.upsample_bilinear(x, scale_factor=8)`` (align_corners=True)."""
    _, h, w, _ = x.shape
    return interpolate_bilinear(x, h * 8, w * 8, align_corners=True)


def affine_grid(theta, h, w):
    """torch-1.2 ``F.affine_grid(theta, (B, C, h, w))`` (align_corners=True).

    theta: (B, 2, 3) affine maps from normalized output coordinates to
    normalized input coordinates. Returns the (B, h, w, 2) sampling grid.
    """
    x = torch.linspace(-1.0, 1.0, w, dtype=theta.dtype, device=theta.device)
    y = torch.linspace(-1.0, 1.0, h, dtype=theta.dtype, device=theta.device)
    gy, gx = torch.meshgrid(y, x, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(-1, 3)
    out = torch.einsum("bij,nj->bni", theta, base)
    return out.reshape(theta.shape[0], h, w, 2)
