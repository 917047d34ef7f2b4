"""Normalized coordinate grids (port of `ransacflow_tpu/ops/grid.py`).

Corner-anchored grids (``linspace(-1, 1, n)``) are sampling and warp grids;
cell-centred coordinates (``((i + 0.5) / n - 0.5) * 2``) place the coarse
feature cells fed to matching and RANSAC.
"""

import torch


def normalized_grid(h, w, device, dtype=torch.float32):
    """Corner-anchored (x, y) grid of shape (h, w, 2), values in [-1, 1]."""
    x = torch.linspace(-1.0, 1.0, w, dtype=dtype, device=device)
    y = torch.linspace(-1.0, 1.0, h, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def feature_cell_coords(h, w, device, dtype=torch.float32):
    """Cell-centred normalized coords of an h x w feature grid.

    Returns (y, x), each (h*w,) in row-major order.
    """
    rows = (torch.arange(h, dtype=dtype, device=device) + 0.5) / h
    cols = (torch.arange(w, dtype=dtype, device=device) + 0.5) / w
    y = ((rows - 0.5) * 2.0).repeat_interleave(w)
    x = ((cols - 0.5) * 2.0).repeat(h)
    return y, x


def feature_cell_indices(h, w, device):
    """Integer (row, col) indices of an h x w grid flattened row-major, each
    (h*w,) int64 (the reference's ``getWHTensor_Int``)."""
    rows = torch.arange(h, device=device).repeat_interleave(w)
    cols = torch.arange(w, device=device).repeat(h)
    return rows, cols
