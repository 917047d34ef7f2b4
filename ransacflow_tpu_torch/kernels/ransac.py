"""Kernel 3: the fixed-count RANSAC fit in one launch (`csrc/ransac.cu`):
draw, solve, score, pick the winner and write its inlier mask, for 4-point
homographies or 3-point affine maps.

The draws are Philox4x32-10 of the hypothesis index under a seed tensor
(`draw_sets_ref` is their plain version, bit for bit the kernel's), so a
fit needs one seed drawn from the caller's generator and nothing read back.
`ransac_fit` takes one problem of N matches, or k of them under a leading
pair axis of the inputs, fitted in one launch, pair p under seed p.
"""

import ctypes
from typing import NamedTuple

import torch

from ransacflow_tpu_torch.kernels.build import Kernel, check, forbid_grad, ptr, stream
from ransacflow_tpu_torch.ops.homography import dlt_homography, fit_affine, reprojection_error

# the minimal set of each transform the kernels fit
TRANSFORMS = {"homography": 4, "affine": 3}
DET_EPS = 1e-6  # kDetEps in the source: the homographies' |det| gate
HYP_PER_BLOCK = 32  # kHyp in csrc/ransac.cu: hypotheses a thread block takes at a time
SLOT_WORDS = 16  # kSlotWords in the source
# up to this many matches each thread block keeps the valid-first order in
# shared memory beside a tile of kTileMax matches (kSharedOrderMax in the
# source); above it one scan kernel writes the order to global memory first
SHARED_ORDER_MAX = 40960
# the kernels index the (N, 3) match arrays with int32: 3 N < 2^31
MAX_MATCHES = (2 ** 31 - 1) // 3
KERNEL = Kernel("rf_ransac_fit",
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                + [ctypes.c_int, ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 9)

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


class RansacResult(NamedTuple):
    """One fit; k fits' has a leading pair axis on every field."""
    H21: torch.Tensor          # (3, 3) best model (target -> source)
    num_inliers: torch.Tensor  # () int32
    inlier_mask: torch.Tensor  # (N,) bool over the padded match arrays
    found: torch.Tensor        # () bool: num_inliers > 0 and enough matches
    best_sample: torch.Tensor  # (n_points,) match indices of the winning set


class Record(NamedTuple):
    """Per hypothesis, for checks: its count and its set of match indices
    (k fits' with a leading pair axis)."""
    counts: torch.Tensor  # (rows,) int32
    sets: torch.Tensor    # (rows, n_points) int32


def stack_fits(fits):
    """NamedTuples of single fits (RansacResult, Record) -> one of the same
    type with a leading pair axis."""
    return type(fits[0])(*(torch.stack(f) for f in zip(*fits)))


def pair_of(batch, p):
    """Pair p of k fits' RansacResult or Record."""
    return type(batch)(*(f[p] for f in batch))


def _mulhilo(m, x):
    """(hi, lo) 32-bit words of m * x, m < 2**32 an int and x an int64
    tensor of 32-bit values, exact in int64 by 16-bit halves."""
    p_hi = m * (x >> 16)
    t = ((p_hi & 0xFFFF) << 16) + m * (x & 0xFFFF)
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32(counter, key):
    """Philox4x32-10 (Random123's constants and rounds) in int64 tensor ops.
    counter: 4 int64 tensors of 32-bit values; key: 2 of them. Returns the
    4 output words, as `csrc/ransac_common.cuh` philox4x32_10."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def n_points_of(transform):
    """The minimal set's size of a transform the kernels fit."""
    if transform not in TRANSFORMS:
        raise ValueError(f"transform={transform!r}: one of {sorted(TRANSFORMS)}")
    return TRANSFORMS[transform]


def draw_sets_ref(valid, seed, n_rows, first=0, n_points=4):
    """Plain version of the kernels' draws: (n_rows, n_points) int32 match
    indices of hypotheses first .. first + n_rows. Hypothesis h takes
    Philox4x32-10 of counter (h, 0, 0, 0) under key (seed low word, seed
    high word); its first n_points words (x, y, z, w) are the set, so a
    3-point set is the first three columns of the 4-point set under one
    seed. Word x becomes rank min(floor(fp32((x >> 8) * 2^-24) * fp32(n_valid)),
    n_valid - 1) of the stable valid-first order (index 0 when no match is
    valid). seed: (1,) int64 in [0, 2**62) on valid's device."""
    dev = valid.device
    h = torch.arange(first, first + n_rows, dtype=torch.int64, device=dev)
    zero = torch.zeros_like(h)
    words = philox4x32((h, zero, zero, zero), (seed & _MASK32, seed >> 32))
    order = torch.argsort((~valid).to(torch.uint8), stable=True)
    bound = valid.sum().clamp_min(1)
    u = (torch.stack(words[:n_points], dim=1) >> 8).to(torch.float32) * 2.0 ** -24
    rank = torch.minimum((u * bound).floor().long(), bound - 1)
    return order[rank].to(torch.int32)


def ransac_score_ref(match1, match2, valid, samples, tolerance, transform="homography"):
    """Plain PyTorch. match1, match2 (N, 3); valid (N,) bool; samples
    (n_iter, n_points) int32 match indices -> (H21 (n_iter, 3, 3), counts
    (n_iter,) int32), count 0 for a set with a repeated index, and for a
    homography with |det H| <= 1e-6 (affine fits have no such gate, as in
    the reference)."""
    n_points = samples.shape[1]
    idx = samples.long()
    unique = (idx[:, :, None] == idx[:, None, :]).sum(dim=(1, 2)) <= n_points
    if transform == "affine":
        H = fit_affine(match1[idx], match2[idx])
        ok = unique
    else:
        H = dlt_homography(match1[idx], match2[idx])
        ok = unique & (torch.linalg.det(H).abs() > DET_EPS)
    ex = match2 @ H[:, 0, :].T  # (N, n_iter)
    ey = match2 @ H[:, 1, :].T
    ez = match2 @ H[:, 2, :].T
    du = ex / ez - match1[:, 0:1]
    dv = ey / ez - match1[:, 1:2]
    tol = torch.full((), tolerance, dtype=match1.dtype, device=match1.device)
    hit = (du * du + dv * dv < tol * tol) & valid[:, None]
    return H, hit.sum(dim=0).to(torch.int32) * ok


def boundary_flips(match1, match2, valid, sets, counts, counts_ref, tolerance,
                   window=1e-5, transform="homography"):
    """For checks of a kernel's per-hypothesis counts against the plain
    version's on the same sets: (differ, explained) bool (rows,). A count
    that differs is explained when it differs by no more than the valid
    matches whose residual under the plain version's H lies within `window`
    of the tolerance. Two fp32 solves of one set differ in their last bits
    (up to ~1e-6 in H), which moves a residual by a few times that and flips
    a match that close to the tolerance; 1e-5 covers that."""
    differ = counts != counts_ref
    rows = differ.nonzero()[:, 0]
    explained = torch.zeros_like(differ)
    if rows.numel():
        H, _ = ransac_score_ref(match1, match2, valid, sets[rows], tolerance, transform)
        ex, ey, ez = (match2 @ H[:, r, :].T for r in range(3))  # (N, rows)
        du = ex / ez - match1[:, 0:1]
        dv = ey / ez - match1[:, 1:2]
        near = (((du * du + dv * dv).sqrt() - tolerance).abs() <= window) & valid[:, None]
        explained[rows] = (counts[rows] - counts_ref[rows]).abs() <= near.sum(dim=0)
    return differ, explained


def winner_mask(match1, match2, valid, H21, tolerance):
    """The reference's inlier mask of one model (`ops/ransac.py:181-182`)."""
    return (reprojection_error(match1, match2, H21[None])[0] < tolerance) & valid


def ransac_fit_ref(match1, match2, valid, tolerance, n_iter, seed=None, samples=None,
                   transform="homography"):
    """Plain PyTorch: the sets drawn under `seed` (or `samples`, (n_iter,
    n_points) int32), scored, the argmax (first index on ties) and the
    winner's mask. Returns (RansacResult, Record). k problems (match1,
    match2 (k, N, 3), valid (k, N), seed (k,) or samples (k, n_iter,
    n_points)) are fitted pair by pair, pair p under seed[p:p + 1] (or
    samples[p]), and stacked."""
    if match1.dim() == 3:
        fits = [ransac_fit_ref(match1[p], match2[p], valid[p], tolerance, n_iter,
                               None if seed is None else seed[p:p + 1],
                               None if samples is None else samples[p], transform)
                for p in range(match1.shape[0])]
        return stack_fits([f[0] for f in fits]), stack_fits([f[1] for f in fits])
    n_points = n_points_of(transform)
    sets = draw_sets_ref(valid, seed, n_iter, n_points=n_points) if samples is None else samples
    H, counts = ransac_score_ref(match1, match2, valid, sets, tolerance, transform)
    # a (1,) index gathers on the device; a 0-d tensor index is read back
    best = torch.argmax(counts).view(1)
    best_H = H.index_select(0, best)[0]
    n_inl = counts.index_select(0, best)[0]
    found = (n_inl > 0) & (valid.sum() >= n_points)
    return (RansacResult(best_H, n_inl, winner_mask(match1, match2, valid, best_H, tolerance),
                         found, sets.index_select(0, best)[0]),
            Record(counts, sets))


def check_matches(match1, match2, valid):
    """The kernels' checks of their match arrays: (N, 3), (N, 3) and (N,)
    for one fit, or (k, N, 3), (k, N, 3) and (k, N) for k, told apart by
    match1's rank. Returns (lead, k, N, device, the valid-first order's
    scratch (k, N + 1) int32 or None): `lead`, (k,) or (), leads every
    output's shape."""
    lead = tuple(match1.shape[:1]) if match1.dim() == 3 else ()
    n = match1.shape[len(lead)] if match1.dim() > len(lead) else 0
    dev = match1.device
    if n > MAX_MATCHES:
        raise ValueError(f"{n} matches: the RANSAC kernels take at most {MAX_MATCHES} "
                         "(int32 indexing of the (N, 3) match arrays)")
    check(match1, "match1", torch.float32, shape=lead + (n, 3))
    check(match2, "match2", torch.float32, shape=lead + (n, 3), device=dev)
    check(valid, "valid", torch.bool, shape=lead + (n,), device=dev)
    k = lead[0] if lead else 1
    order = (torch.empty((k, n + 1), dtype=torch.int32, device=dev) if n > SHARED_ORDER_MAX
             else None)
    return lead, k, n, dev, order


def draw_source(seed, samples, lead, n_rows, dev, n_points):
    """Pointer of the seeds (one a fit) or of the checked injected sets
    (lead + (n_rows, n_points)) (exactly one)."""
    if (seed is None) == (samples is None):
        raise ValueError("give exactly one of seed and samples")
    if samples is not None:
        check(samples, "samples", torch.int32, shape=lead + (n_rows, n_points), device=dev)
        return None, ptr(samples)
    check(seed, "seed", torch.int64, shape=(lead[0] if lead else 1,), device=dev)
    return ptr(seed), None


def outputs(lead, n, dev, n_points):
    """(H lead + (9,) fp32, ints lead + (8,) int32, mask and found lead + (N
    + 1,) bool) and the RansacResult viewing them: a single fit's (lead ())
    has the bytes of k = 1 fits', without the pair axis."""
    # shapes as separate ints: PyTorch parses a tuple argument more slowly
    H = torch.empty(*lead, 9, dtype=torch.float32, device=dev)
    ints = torch.empty(*lead, 8, dtype=torch.int32, device=dev)
    flags = torch.empty(*lead, n + 1, dtype=torch.bool, device=dev)
    return H, ints, flags, RansacResult(H.view(*lead, 3, 3), ints[..., 0], flags[..., :n],
                                        flags[..., n], ints[..., 1:1 + n_points])


def record_outputs(lead, n_rows, dev, n_points):
    return Record(torch.empty(lead + (n_rows,), dtype=torch.int32, device=dev),
                  torch.empty(lead + (n_rows, n_points), dtype=torch.int32, device=dev))


_STATES = {}


def _state(dev, raw_stream, k):
    """The kernel's two words a pair for a stream: zeroed once, and left
    zeroed by every launch; grown (zeroed anew) for a larger batch."""
    key = (dev.index, raw_stream)
    state = _STATES.get(key)
    if state is None or state.numel() < 2 * k:
        state = _STATES[key] = torch.zeros(2 * k, dtype=torch.int64, device=dev)
    return state


def ransac_fit(match1, match2, valid, tolerance, n_iter, seed=None, samples=None,
               record=False, transform="homography"):
    """`ransac_fit_ref` for CPU tensors, one launch of the kernel for CUDA
    ones (above SHARED_ORDER_MAX matches, a scan kernel before it writes the
    valid-first order): the sets drawn under `seed` ((1,) int64 on the
    device) or read from `samples` ((n_iter, n_points) int32 in [0, N)).
    k problems under a leading pair axis (match1, match2 (k, N, 3), valid
    (k, N), seed (k,) or samples (k, n_iter, n_points)) are one launch for
    all k fits, at most 65535, each pair's count, winner and mask those of
    its own fit; one problem is the kernel's k = 1, its outputs shaped
    without the pair axis. transform: 'homography' (4-point sets) or
    'affine' (3-point sets). Returns (RansacResult, Record or None): the
    Record of every hypothesis when `record`. Nothing is read back. Forward
    only: raises when a match array requires grad under grad mode."""
    forbid_grad("ransac_fit", match1, match2)
    if match1.device.type == "cpu":
        res, rec = ransac_fit_ref(match1, match2, valid, tolerance, n_iter, seed, samples,
                                  transform)
        return res, rec if record else None
    n_points = n_points_of(transform)
    lead, k, n, dev, order = check_matches(match1, match2, valid)
    if k > 65535:
        raise ValueError(f"ransac_fit: {k} pairs, at most 65535")
    seed_ptr, samples_ptr = draw_source(seed, samples, lead, n_iter, dev, n_points)
    H, ints, flags, res = outputs(lead, n, dev, n_points)
    rec = record_outputs(lead, n_iter, dev, n_points) if record else None
    counts_ptr, sets_ptr = (ptr(rec.counts), ptr(rec.sets)) if rec else (None, None)
    slots = torch.empty(k * -(-n_iter // HYP_PER_BLOCK) * SLOT_WORDS, dtype=torch.float32,
                        device=dev)
    raw_stream = stream(match1)
    KERNEL(dev, ptr(match1), ptr(match2), ptr(valid), n, k, seed_ptr, samples_ptr, n_iter,
           n_points, tolerance, counts_ptr, sets_ptr, ptr(H), ptr(ints), ptr(flags),
           None if order is None else ptr(order), ptr(_state(dev, raw_stream, k)), ptr(slots),
           raw_stream)
    return res, rec
