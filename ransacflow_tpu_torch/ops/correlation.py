"""Offset grids of the local correlation volume (port of
`ransacflow_tpu/ops/correlation.py:44`).

The volume itself, `correlation_volume`, is kernel 6
(`kernels/correlation.py`): channel c = di*k + dj holds the target offset
(di - k//2) rows, (dj - k//2) cols.
"""

import torch


def corr_offset_grids(kernel_size, device, dtype=torch.float32):
    """(gx, gy) offsets per correlation channel, each (k*k,):
    gx[c] = c % k - k//2 (columns), gy[c] = c // k - k//2 (rows)."""
    p = kernel_size // 2
    idx = torch.arange(kernel_size * kernel_size, device=device)
    return (idx % kernel_size - p).to(dtype), (idx // kernel_size - p).to(dtype)
