"""Bilinear sampling and resizing, channels-last, forward only.

Port of `ransacflow_tpu/ops/sampler.py:240-307`. PyTorch's own operators
carry the semantics: `grid_sample` is `F.grid_sample(align_corners=True,
padding_mode='zeros')` and `interpolate_bilinear` is `F.interpolate(mode=
'bilinear')`. The reference's TPU gather workarounds have no counterpart.
"""

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
