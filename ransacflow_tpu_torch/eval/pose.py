"""Two-view relative pose without OpenCV: the essential-matrix RANSAC, the
5-point and 8-point solvers and the cheirality test behind the YFCC metric.

The JAX harness calls `cv2.findEssentialMat(pts1, pts2, method=RANSAC,
threshold=t)` and `cv2.recoverPose(E, pts1, pts2, mask=mask)` on normalized
points (`ransacflow_tpu/eval/yfcc.py:263-290`), that is with focal 1,
principal point (0, 0), confidence 0.999 and at most 1000 iterations. This
module follows OpenCV's contract there (calib3d `five-point.cpp`,
`ptsetreg.cpp`, `fundam.cpp`, `triangulate.cpp`), in float64, the solvers on
the host and the per-point work on a torch device:

- the minimal solver (`five_point_essential`) takes the nullspace of the
  5x9 epipolar system and solves the ten cubic constraints det E = 0 and
  2 E E^T E - tr(E E^T) E = 0 by the eigenvectors of the 10x10 action
  matrix of z (Stewenius), keeping every real solution at unit Frobenius
  norm;
- the RANSAC (`find_essential_mat`) scores each model by the Sampson
  distance, rounded to float32 and compared with float32(threshold^2) as
  OpenCV does, updates its iteration count adaptively and keeps the first
  model with the most inliers. Its draws come from a numpy Generator (not
  OpenCV's RNG), so its models differ from OpenCV's by RANSAC's own
  scatter. Hypotheses are solved and scored in blocks, the scoring on a
  torch device, and walked in draw order, so the result does not depend on
  the block size;
- `eight_point_fundamental` is `cv2.findFundamentalMat(..., FM_8POINT)`
  (the 7-point solver with exactly 7 points, as OpenCV does);
- `recover_pose` decomposes E into (R1, R2, +-t), triangulates each point
  by the 4x4 DLT (a batched SVD on the torch device) and keeps the
  candidate with the most points in front of both cameras and nearer than
  50.
"""

import itertools

import numpy as np
import torch

MODEL_POINTS = 5
CONFIDENCE = 0.999     # cv2.findEssentialMat's prob
MAX_ITERS = 1000       # and maxIters
DISTANCE_THRESH = 50.0  # cv2.recoverPose's depth limit
# hypotheses solved and scored together: the first block, doubled up to the
# largest (the result does not depend on them)
FIRST_BLOCK, MAX_BLOCK = 16, 256
DBL_EPSILON = np.finfo(np.float64).eps
FLT_EPSILON = float(np.finfo(np.float32).eps)

# The monomials of degree <= 3 in (x, y, z): the ten cubics first, then the
# ten of degree <= 2, the basis of the action matrix.
_MONOMIALS = sorted(
    (e for e in itertools.product(range(4), repeat=3) if sum(e) <= 3),
    key=lambda e: (-sum(e), [-v for v in e]))
_INDEX = {e: i for i, e in enumerate(_MONOMIALS)}
_LINEAR = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0))  # E = x E0 + y E1 + z E2 + E3


def _product_table(left, right):
    """T[i, j, k] = 1 where left[i] * right[j] is the monomial k."""
    table = np.zeros((len(left), len(right), len(_MONOMIALS)))
    for i, a in enumerate(left):
        for j, b in enumerate(right):
            table[i, j, _INDEX[tuple(p + q for p, q in zip(a, b))]] = 1.0
    return table


_QUADRATIC = tuple(e for e in _MONOMIALS if sum(e) <= 2)
_LIN_LIN = _product_table(_LINEAR, _LINEAR)[..., [_INDEX[e] for e in _QUADRATIC]]
_QUAD_LIN = _product_table(_QUADRATIC, _LINEAR)


def _action_matrix_rows():
    """For each basis monomial m (the last ten), where z * m lies: a cubic's
    row of the eliminated system (j, None) or a basis monomial (None, k)."""
    rows = []
    for e in _MONOMIALS[10:]:
        k = _INDEX[(e[0], e[1], e[2] + 1)]
        rows.append((k, None) if k < 10 else (None, k - 10))
    return rows


_ACTION = _action_matrix_rows()
_BASIS_X, _BASIS_Y, _BASIS_ONE = (_INDEX[e] - 10 for e in ((1, 0, 0), (0, 1, 0), (0, 0, 0)))


def _constraints(basis):
    """The ten cubic constraints on E = x E0 + y E1 + z E2 + E3.

    basis: (B, 4, 3, 3) nullspace vectors. Returns (B, 10, 20): det E and
    the nine entries of 2 E E^T E - tr(E E^T) E over `_MONOMIALS`."""
    e = np.moveaxis(basis, 1, -1)  # (B, 3, 3, 4): each entry a linear polynomial
    eet = np.einsum("bikp,bjkq,pqr->bijr", e, e, _LIN_LIN)  # (B, 3, 3, 10)
    eete = np.einsum("bikr,bkjq,rqs->bijs", eet, e, _QUAD_LIN)  # (B, 3, 3, 20)
    trace = eet[:, 0, 0] + eet[:, 1, 1] + eet[:, 2, 2]
    tr_e = np.einsum("br,bijq,rqs->bijs", trace, e, _QUAD_LIN)
    minors = (np.einsum("bp,bq,pqr->br", e[:, 1, 1], e[:, 2, 2], _LIN_LIN)
              - np.einsum("bp,bq,pqr->br", e[:, 1, 2], e[:, 2, 1], _LIN_LIN),
              np.einsum("bp,bq,pqr->br", e[:, 1, 2], e[:, 2, 0], _LIN_LIN)
              - np.einsum("bp,bq,pqr->br", e[:, 1, 0], e[:, 2, 2], _LIN_LIN),
              np.einsum("bp,bq,pqr->br", e[:, 1, 0], e[:, 2, 1], _LIN_LIN)
              - np.einsum("bp,bq,pqr->br", e[:, 1, 1], e[:, 2, 0], _LIN_LIN))
    det = sum(np.einsum("br,bq,rqs->bs", m, e[:, 0, c], _QUAD_LIN)
              for c, m in enumerate(minors))
    return np.concatenate([det[:, None], (2.0 * eete - tr_e).reshape(-1, 9, 20)], axis=1)


def _solve_batch(lhs, rhs):
    """np.linalg.solve over a batch; a singular system gives NaNs for its
    item alone."""
    try:
        return np.linalg.solve(lhs, rhs)
    except np.linalg.LinAlgError:
        out = np.full(rhs.shape, np.nan)
        for b in range(len(lhs)):
            try:
                out[b] = np.linalg.solve(lhs[b], rhs[b])
            except np.linalg.LinAlgError:
                pass
        return out


def five_point_batch(x1, x2):
    """The 5-point essential matrices of B minimal sets.

    x1, x2: (B, 5, 2) float64 normalized points, x2^T E x1 = 0.
    Returns (E (M, 3, 3) at unit Frobenius norm, owner (M,) the set index of
    each solution), every real solution of each set in turn."""
    x1, x2 = np.asarray(x1, np.float64), np.asarray(x2, np.float64)
    a, b = x1[..., 0], x1[..., 1]
    c, d = x2[..., 0], x2[..., 1]
    one = np.ones_like(a)
    q = np.stack([c * a, c * b, c, d * a, d * b, d, a, b, one], axis=-1)  # (B, 5, 9)
    basis = np.linalg.svd(q, full_matrices=True)[2][:, 5:9].reshape(-1, 4, 3, 3)
    coeffs = _constraints(basis)
    elim = _solve_batch(coeffs[:, :, :10], coeffs[:, :, 10:])  # the cubics by the basis
    action = np.zeros(elim.shape)
    for i, (cubic, k) in enumerate(_ACTION):
        if cubic is None:
            action[:, i, k] = 1.0
        else:
            action[:, i] = -elim[:, cubic]
    ok = np.isfinite(action).all(axis=(1, 2))
    action[~ok] = 0.0
    values, vectors = np.linalg.eig(action)
    sols, owner = [], []
    for s in np.flatnonzero(ok):
        for k in range(10):
            if abs(values[s, k].imag) > 1e-10:
                continue
            v = vectors[s, :, k]
            if abs(v[_BASIS_ONE]) < 1e-10:
                continue
            x, y = (v[_BASIS_X] / v[_BASIS_ONE]).real, (v[_BASIS_Y] / v[_BASIS_ONE]).real
            e = x * basis[s, 0] + y * basis[s, 1] + values[s, k].real * basis[s, 2] + basis[s, 3]
            norm = np.linalg.norm(e)
            if np.isfinite(norm) and norm > 0:
                sols.append(e / norm)
                owner.append(s)
    if not sols:
        return np.zeros((0, 3, 3)), np.zeros(0, np.int64)
    return np.stack(sols), np.asarray(owner)


def five_point_essential(x1, x2):
    """Every real essential matrix of 5 correspondences, (k, 3, 3) at unit
    Frobenius norm (k = 0 when there is none)."""
    return five_point_batch(np.asarray(x1)[None], np.asarray(x2)[None])[0]


def sampson_errors(E, x1, x2):
    """The Sampson distance of every point under every model, in float64
    and then rounded to float32 as OpenCV's essential-matrix callback does:
    (x2^T E x1)^2 / ((E x1)_0^2 + (E x1)_1^2 + (E^T x2)_0^2 + (E^T x2)_1^2).

    E: (M, 3, 3) float64 tensor; x1, x2: (n, 2) float64 tensors on its
    device. Returns (M, n) float32. The products are matrix products, so
    they sum in another order than OpenCV's loop: a float32 value can differ
    in its last bit (a point within ~1e-7 relative of the threshold)."""
    n = x1.shape[0]
    one = torch.ones((n, 1), dtype=x1.dtype, device=x1.device)
    h1, h2 = torch.cat([x1, one], dim=1), torch.cat([x2, one], dim=1)
    num = E.reshape(-1, 9) @ (h2[:, :, None] * h1[:, None, :]).reshape(n, 9).T
    ex1 = torch.matmul(h1, E[:, :2, :].transpose(1, 2))
    etx2 = torch.matmul(h2, E[:, :, :2])
    den = ex1.square().sum(dim=-1) + etx2.square().sum(dim=-1)
    return (num * num / den).to(torch.float32)


def _inlier_counts(E, x1, x2, thresh2, chunk_elems=1 << 24):
    """Inliers of each model (error <= float32 threshold^2), in chunks of
    models of about chunk_elems (model, point) pairs."""
    step = max(1, chunk_elems // max(1, x1.shape[0]))
    e = torch.as_tensor(E, dtype=torch.float64, device=x1.device)
    counts = [(sampson_errors(e[i:i + step], x1, x2) <= thresh2).sum(dim=1)
              for i in range(0, e.shape[0], step)]
    return torch.cat(counts).cpu().numpy() if counts else np.zeros(0, np.int64)


def update_num_iters(outlier_ratio, max_iters):
    """OpenCV's RANSACUpdateNumIters: log(1 - p) / log(1 - (1 - ep)^5) at
    p = CONFIDENCE, rounded half to even, never above max_iters."""
    ep = min(max(outlier_ratio, 0.0), 1.0)
    num = max(1.0 - CONFIDENCE, np.finfo(np.float64).tiny)
    denom = 1.0 - (1.0 - ep) ** MODEL_POINTS
    if denom < np.finfo(np.float64).tiny:
        return 0
    num, denom = np.log(num), np.log(denom)
    if denom >= 0 or -num >= max_iters * (-denom):
        return max_iters
    return int(np.rint(num / denom))


def draw_subsets(rng, n, count):
    """`count` sets of 5 distinct indices below n, one float64 uniform per
    index in draw order (so that blocks of any size read the same stream):
    index j is the floor(u * (n - j))-th of those not yet in its set."""
    k = np.arange(MODEL_POINTS)
    ranks = np.minimum((rng.random((count, MODEL_POINTS)) * (n - k)).astype(np.int64),
                       n - 1 - k)
    idx = np.empty((count, MODEL_POINTS), np.int64)
    for j in range(MODEL_POINTS):
        c = ranks[:, j].copy()
        for s in np.sort(idx[:, :j], axis=1).T:
            c += c >= s
        idx[:, j] = c
    return idx


def find_essential_mat(x1, x2, threshold=1.0, seed=0, *, device):
    """`cv2.findEssentialMat(x1, x2, method=cv2.RANSAC, threshold=threshold)`
    on normalized points (focal 1, principal point (0, 0), prob CONFIDENCE,
    maxIters MAX_ITERS).

    x1, x2: (n, 2) points. seed: the numpy Generator's seed of the draws.
    device: where hypotheses are scored against all points (float64).
    Returns (E (3, 3) float64, mask (n, 1) uint8), or with exactly 5 points
    every solution stacked (3k, 3) and a mask of ones, as OpenCV does; (None,
    None) with fewer than 5 points or when no model has 5 inliers.
    """
    x1 = np.asarray(x1, np.float64).reshape(-1, 2)
    x2 = np.asarray(x2, np.float64).reshape(-1, 2)
    n = x1.shape[0]
    if n < MODEL_POINTS:
        return None, None
    if n == MODEL_POINTS:
        sols = five_point_essential(x1, x2)
        if not len(sols):
            return None, None
        return sols.reshape(-1, 3), np.ones((n, 1), np.uint8)

    rng = np.random.default_rng(seed)
    p1 = torch.as_tensor(x1, device=device)
    p2 = torch.as_tensor(x2, device=device)
    thresh2 = np.float32(threshold * threshold)
    niters, block = MAX_ITERS, FIRST_BLOCK
    best, best_count = None, 0
    it = 0
    while it < niters:
        idx = draw_subsets(rng, n, block)
        models, owner = five_point_batch(x1[idx], x2[idx])
        counts = _inlier_counts(models, p1, p2, float(thresh2))
        for h in range(block):
            if it + h >= niters:
                break
            for m in np.flatnonzero(owner == h):
                if counts[m] > max(best_count, MODEL_POINTS - 1):
                    best, best_count = models[m], int(counts[m])
                    niters = update_num_iters((n - best_count) / n, niters)
        it += block
        block = min(2 * block, MAX_BLOCK)
    if best is None:
        return None, None
    errors = sampson_errors(torch.as_tensor(best[None], device=device), p1, p2)[0]
    return best, (errors <= float(thresh2)).cpu().numpy().astype(np.uint8)[:, None]


def _hartley(x):
    """OpenCV's normalization of a point set: the centroid to the origin and
    the mean distance to sqrt(2). Returns (normalized points, T) or None
    when the set has no spread."""
    center = x.mean(axis=0)
    scale = np.sqrt((x[:, 0] - center[0]) ** 2 + (x[:, 1] - center[1]) ** 2).mean()
    if scale < FLT_EPSILON:
        return None
    scale = np.sqrt(2.0) / scale
    T = np.array([[scale, 0, -scale * center[0]], [0, scale, -scale * center[1]], [0, 0, 1]])
    return (x - center) * scale, T


def _epipolar_rows(a, b):
    """Rows of the system (b, 1)^T F (a, 1) = 0 over F's row-major entries."""
    x1, y1, x2, y2 = a[:, 0], a[:, 1], b[:, 0], b[:, 1]
    return np.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, np.ones_like(x1)],
                    axis=1)


def _unit_f22(F):
    return F / F[2, 2] if abs(F[2, 2]) > FLT_EPSILON else F


def _seven_point(a, b, T1, T2):
    """OpenCV's run7Point on normalized points: F = lambda F1 + (1 -
    lambda) F2 with det F = 0, each real root a (3, 3) block."""
    vt = np.linalg.svd(_epipolar_rows(a, b), full_matrices=True)[2]
    f1, f2 = vt[7] - vt[8], vt[8]
    # det(lambda f1 + f2) as a cubic in lambda: det is multilinear in rows
    F1, F2 = f1.reshape(3, 3), f2.reshape(3, 3)
    coeffs = [sum(np.linalg.det(np.where(np.array(pick)[:, None], F1, F2))
                  for pick in itertools.product((0, 1), repeat=3) if sum(pick) == k)
              for k in (3, 2, 1, 0)]
    roots = np.roots(coeffs) if abs(coeffs[0]) > 0 else np.roots(coeffs[1:])
    out = []
    for r in roots[np.abs(roots.imag) <= 1e-10].real:
        lam, mu = r, 1.0
        s = f1[8] * r + f2[8]
        if abs(s) > DBL_EPSILON:
            mu = 1.0 / s
            lam *= mu
        f = f1 * lam + f2 * mu
        f[8] = 1.0 if abs(s) > DBL_EPSILON else 0.0
        out.append(_unit_f22(T2.T @ f.reshape(3, 3) @ T1))
    return out


def eight_point_fundamental(x1, x2):
    """`cv2.findFundamentalMat(x1, x2, cv2.FM_8POINT)`: the points taken as
    float32, Hartley-normalized, the 9x9 normal equations' smallest
    eigenvector made rank 2 by SVD, denormalized, F[2, 2] = 1. Exactly 7
    points run the 7-point solver (every real root, stacked). Returns (F
    (3k, 3), mask of ones (n, 1) uint8) or (None, None) with fewer than 7
    points or a degenerate set."""
    a = np.asarray(x1, np.float32).reshape(-1, 2).astype(np.float64)
    b = np.asarray(x2, np.float32).reshape(-1, 2).astype(np.float64)
    n = a.shape[0]
    if n < 7:
        return None, None
    na, nb = _hartley(a), _hartley(b)
    if na is None or nb is None:
        return None, None
    (a, T1), (b, T2) = na, nb
    mask = np.ones((n, 1), np.uint8)
    if n == 7:
        fs = _seven_point(a, b, T1, T2)
        return (np.concatenate(fs), mask) if fs else (None, None)
    rows = _epipolar_rows(a, b)
    w, v = np.linalg.eigh(rows.T @ rows)  # ascending
    if abs(w[1]) < DBL_EPSILON:  # rank under 8
        return None, None
    u, s, vt = np.linalg.svd(v[:, 0].reshape(3, 3))
    F = u @ np.diag([s[0], s[1], 0.0]) @ vt
    return _unit_f22(T2.T @ F @ T1), mask


def decompose_essential(E):
    """`cv2.decomposeEssentialMat`: (R1, R2, t) with U and V^T taken with
    positive determinant, R1 = U W V^T, R2 = U W^T V^T, t = U[:, 2]."""
    u, _, vt = np.linalg.svd(np.asarray(E, np.float64).reshape(3, 3))
    if np.linalg.det(u) < 0:
        u = -u
    if np.linalg.det(vt) < 0:
        vt = -vt
    w = np.array([[0.0, 1, 0], [-1, 0, 0], [0, 0, 1]])
    return u @ w @ vt, u @ w.T @ vt, u[:, 2].copy()


def _triangulate(P, x1, x2, device):
    """The DLT point of each correspondence between [I | 0] and P: the last
    right singular vector of its 4x4 system, (n, 4) homogeneous, the
    batched SVD on `device`."""
    n = x1.shape[0]
    A = np.zeros((n, 4, 4))
    A[:, 0, 0] = A[:, 1, 1] = -1.0
    A[:, 0, 2], A[:, 1, 2] = x1[:, 0], x1[:, 1]
    A[:, 2] = x2[:, 0, None] * P[2] - P[0]
    A[:, 3] = x2[:, 1, None] * P[2] - P[1]
    return torch.linalg.svd(torch.as_tensor(A, device=device))[2][:, 3].cpu().numpy()


def _in_front(Q, R, t):
    """OpenCV's cheirality test of triangulated points Q (n, 4) for the
    camera [R | t]: positive depth in both cameras, under DISTANCE_THRESH in
    both."""
    ok = Q[:, 2] * Q[:, 3] > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        X = Q[:, :3] / Q[:, 3:]
    z2 = X @ R[2] + t[2]
    return ok & (X[:, 2] < DISTANCE_THRESH) & (z2 > 0) & (z2 < DISTANCE_THRESH)


def recover_pose(E, x1, x2, mask=None, *, device):
    """`cv2.recoverPose(E, x1, x2, mask=mask)` on normalized points: of the
    four poses (R1, t), (R2, t), (R1, -t), (R2, -t), the first with the most
    points (nonzero in `mask`) in front of both cameras and nearer than
    DISTANCE_THRESH. device: where the points' 4x4 systems are solved.
    Returns (count, R (3, 3), t (3, 1)).

    A pose with -t triangulates each point to the +t pose's point with its
    last homogeneous coordinate negated, so two DLT solves a point serve
    the four poses."""
    x1 = np.asarray(x1, np.float64).reshape(-1, 2)
    x2 = np.asarray(x2, np.float64).reshape(-1, 2)
    if mask is not None:
        keep = np.asarray(mask).reshape(-1) != 0
        x1, x2 = x1[keep], x2[keep]
    R1, R2, t = decompose_essential(E)
    Q1, Q2 = (_triangulate(np.concatenate([R, t[:, None]], axis=1), x1, x2, device)
              for R in (R1, R2))
    flip = np.array([1.0, 1.0, 1.0, -1.0])
    poses = ((R1, t, Q1), (R2, t, Q2), (R1, -t, Q1 * flip), (R2, -t, Q2 * flip))
    good = [int(_in_front(Q, R, tt).sum()) for R, tt, Q in poses]
    best = int(np.argmax(good))
    return good[best], poses[best][0], poses[best][1][:, None]
