"""Homographies: application, warp grids, the 4-point solve, the affine
least-squares fit and the reprojection error.

Port of `ransacflow_tpu/ops/homography.py` (the 'projective' solve,
`fit_affine`, `fit_hough` and `fit_translation`). The torch functions batch
over leading dimensions; `dlt_homography_np` is the host fp64 solve of one
set.
"""

import math

import numpy as np
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


def fit_affine(X, Y):
    """Least-squares affine fit X ~ Y @ M through the 3x3 normal equations
    (port of `ransacflow_tpu/ops/homography.py:217`), batched.

    Solved in closed form, M = adj(YtY) @ YtX / det(YtY), with the sums over
    the points taken in order and every product and sum a tensor op of its
    own: the sequence of roundings that the RANSAC kernels' affine solve
    repeats (`csrc/ransac_common.cuh` affine_fit), of which this is the
    plain version. A singular YtY (collinear points) gives inf or nan
    entries, never an error.

    X: (..., N, 3) source homogeneous points; Y: (..., N, 3) target ones.
    Returns (..., 3, 3) with last row [0, 0, 1].
    """
    X2 = X[..., :2]
    YtY = Y[..., 0, :, None] * Y[..., 0, None, :]
    YtX = Y[..., 0, :, None] * X2[..., 0, None, :]
    for k in range(1, Y.shape[-2]):
        YtY = YtY + Y[..., k, :, None] * Y[..., k, None, :]
        YtX = YtX + Y[..., k, :, None] * X2[..., k, None, :]
    adj = _adjugate_3x3(YtY)
    det = (YtY[..., 0, 0] * adj[..., 0, 0] + YtY[..., 0, 1] * adj[..., 1, 0]) \
        + YtY[..., 0, 2] * adj[..., 2, 0]
    M = (adj[..., :, 0, None] * YtX[..., 0, None, :]
         + adj[..., :, 1, None] * YtX[..., 1, None, :]) \
        + adj[..., :, 2, None] * YtX[..., 2, None, :]
    top = (M / det[..., None, None]).transpose(-1, -2)  # (..., 2, 3)
    bottom = torch.tensor([0.0, 0.0, 1.0], dtype=X.dtype, device=X.device)
    return torch.cat([top, bottom.expand(*top.shape[:-2], 1, 3)], dim=-2)


def _diag_affine(sx, sy, tx, ty):
    """(..., 3, 3) [[sx, 0, tx], [0, sy, ty], [0, 0, 1]]."""
    zeros, ones = torch.zeros_like(sx), torch.ones_like(sx)
    return torch.stack([
        torch.stack([sx, zeros, tx], dim=-1),
        torch.stack([zeros, sy, ty], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ], dim=-2)


def fit_hough(X, Y):
    """Axis-aligned scale and translation fit (port of
    `ransacflow_tpu/ops/homography.py:236`; the reference's
    utils/outil.py:57-66, which its main path does not call): per axis the
    least squares [y, 1] @ [s, t] = x through the 2x2 normal equations.

    X: (..., N, 2|3) source points; Y: (..., N, 2|3) target ones.
    Returns (..., 3, 3) [[sx, 0, tx], [0, sy, ty], [0, 0, 1]].
    """
    def axis_fit(y, x):
        a11 = (y * y).sum(dim=-1)
        a12 = y.sum(dim=-1)
        a22 = torch.ones_like(y).sum(dim=-1)
        b1 = (y * x).sum(dim=-1)
        b2 = x.sum(dim=-1)
        det = a11 * a22 - a12 * a12
        return (a22 * b1 - a12 * b2) / det, (a11 * b2 - a12 * b1) / det

    sx, tx = axis_fit(Y[..., 0], X[..., 0])
    sy, ty = axis_fit(Y[..., 1], X[..., 1])
    return _diag_affine(sx, sy, tx, ty)


def fit_translation(X, Y):
    """The translation of the FIRST correspondence of each set, as the
    reference's utils/outil.py:89-95 takes it (port of
    `ransacflow_tpu/ops/homography.py:273`).

    X, Y: (..., N, 2|3). Returns (..., 3, 3).
    """
    tx = X[..., 0, 0] - Y[..., 0, 0]
    ty = X[..., 0, 1] - Y[..., 0, 1]
    ones = torch.ones_like(tx)
    return _diag_affine(ones, ones, tx, ty)


def reprojection_error(match1, match2, H21):
    """L2 distance of each match1 to match2 mapped by each H21.

    match1, match2: (N, 3) homogeneous; H21: (..., 3, 3). Returns (..., N).
    """
    d = match1[..., :2] - apply_homography(H21, match2[..., :2])
    return torch.sqrt((d * d).sum(dim=-1))


def dlt_homography_np(X, Y):
    """Host fp64 single-set DLT (numpy SVD), used to polish the RANSAC
    winner; a copy of `ransacflow_tpu/ops/homography.py:187`.

    Reproduces the reference's numpy-SVD numerics (utils/outil.py:68-87)
    bit for bit: the cross products (v'u etc.) round in the inputs' float32
    before entering the fp64 system, so inputs keep their dtype here.

    X: (4, 2|3) source points, Y: (4, 2|3) target points (numpy).
    Returns (3, 3) float64 H21 (unit-norm null vector).
    """
    X = np.asarray(X)
    Y = np.asarray(Y)
    A = np.zeros((8, 9))
    for i in range(4):
        u, v = Y[i, 0], Y[i, 1]
        up, vp = X[i, 0], X[i, 1]
        A[2 * i] = [0, 0, 0, -u, -v, -1, vp * u, vp * v, vp]
        A[2 * i + 1] = [u, v, 1, 0, 0, 0, -up * u, -up * v, -up]
    _, _, vh = np.linalg.svd(A)
    return vh[8].reshape(3, 3)
