"""Homographies: application, warp grids, the 4-point solve and its error.

Port of `ransacflow_tpu/ops/homography.py` (the 'projective' solve only).
All functions batch over leading dimensions.
"""

import math

import torch

from ransacflow_tpu_torch.ops.grid import normalized_grid


def apply_homography(H, pts):
    """Apply (..., 3, 3) homographies to (..., N, 2|3) points and dehomogenize.

    Returns (..., N, 2).
    """
    if pts.shape[-1] == 2:
        pts = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    out = torch.einsum("...ij,...nj->...ni", H, pts)
    return out[..., :2] / out[..., 2:3]


def warp_grid(H, h, w):
    """kornia ``HomographyWarper(h, w).warp_grid(H)``: the corner-anchored
    (x, y) grid of the destination mapped through H (dst -> src).

    H: (B, 3, 3). Returns (B, h, w, 2).
    """
    pts = normalized_grid(h, w, H.device, H.dtype).reshape(-1, 2)
    out = apply_homography(H, pts.expand(H.shape[0], -1, -1))
    return out.reshape(H.shape[0], h, w, 2)


def _hartley_normalize(P):
    """Per-set similarity normalization: centroid 0, mean distance sqrt(2).

    P: (..., n, 2). Returns (T, Pn), Pn the points mapped by T (..., 3, 3).
    """
    c = P.mean(dim=-2, keepdim=True)
    d = torch.sqrt(((P - c) ** 2).sum(dim=-1)).mean(dim=-1)
    # tensor / tensor: `float / tensor` would multiply by a rounded reciprocal
    s = d.new_full((), math.sqrt(2.0)) / d.clamp_min(1e-12)
    Pn = (P - c) * s[..., None, None]
    zeros = torch.zeros_like(s)
    ones = torch.ones_like(s)
    cx, cy = c[..., 0, 0], c[..., 0, 1]
    T = torch.stack([
        torch.stack([s, zeros, -s * cx], dim=-1),
        torch.stack([zeros, s, -s * cy], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ], dim=-2)
    return T, Pn


def _adjugate_3x3(M):
    """Closed-form 3x3 adjugate: ``M @ adj(M) = det(M) * I``."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1),
    ], dim=-2)


def _basis_transform(P):
    """3x3 map sending the projective basis e1, e2, e3, (1,1,1) to 4 points."""
    p = torch.cat([P, torch.ones_like(P[..., :1])], dim=-1)  # (..., 4, 3)
    M = torch.stack([p[..., 0, :], p[..., 1, :], p[..., 2, :]], dim=-1)
    c = torch.einsum("...ij,...j->...i", _adjugate_3x3(M), p[..., 3, :])
    return M * c[..., None, :]


def dlt_homography(X, Y):
    """Batched 4-point homographies H21 with X ~ Y @ H21^T.

    Hartley-normalizes both sets, builds H in closed form from the
    projective basis (H = T_X @ adj(T_Y)), denormalizes, and scales it to unit
    Frobenius norm.

    X, Y: (..., 4, 2|3). Returns (..., 3, 3).
    """
    T1, Xn = _hartley_normalize(X[..., :2])
    T2, Yn = _hartley_normalize(Y[..., :2])
    Hn = _basis_transform(Xn) @ _adjugate_3x3(_basis_transform(Yn))
    T1_inv = _adjugate_3x3(T1) / torch.linalg.det(T1).clamp_min(1e-20)[..., None, None]
    H = T1_inv @ Hn @ T2
    norm = torch.linalg.norm(H.reshape(*H.shape[:-2], 9), dim=-1)
    return H / norm.clamp_min(1e-12)[..., None, None]


def reprojection_error(match1, match2, H21):
    """L2 distance of each match1 to match2 mapped by each H21.

    match1, match2: (N, 3) homogeneous; H21: (..., 3, 3). Returns (..., N).
    """
    d = match1[..., :2] - apply_homography(H21, match2[..., :2])
    return torch.sqrt((d * d).sum(dim=-1))
