"""Kernel 4: adaptive RANSAC, hypotheses in blocks until the confidence bound
is met, as one persistent cooperative launch (`csrc/ransac_adaptive.cu`), for
4-point homographies or 3-point affine maps. k fits under a leading pair
axis of the inputs run in one launch, each to its own bound."""

import ctypes

import torch

from ransacflow_tpu_torch.kernels.build import Kernel, forbid_grad, ptr, stream
from ransacflow_tpu_torch.kernels.ransac import (
    SLOT_WORDS, RansacResult, Record, check_matches, draw_sets_ref, draw_source, n_points_of,
    outputs, ransac_score_ref, record_outputs, stack_fits, winner_mask)

KERNEL = Kernel("rf_ransac_adaptive",
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 10)
EVALUATED = 6  # the kernel's ints: count, set (4), blocks run, hypotheses evaluated
HYP_PER_BLOCK = 16  # kHyp in csrc/ransac_adaptive.cu: hypotheses a thread block takes
MAX_PAIRS = 256  # kMaxPairs in the source: fits of one batch launch


def _chunk_done(best_count, n_valid, evaluated, n_iter, confidence, n_points=4):
    """The reference's stop test in fp32 (`ops/ransac.py:275-279`), w **
    n_points as `lax.integer_pow` multiplies: (w w)(w w), or w (w w)."""
    f32 = torch.float32
    w = best_count.to(f32) / n_valid.clamp_min(1).to(f32)
    w_n = w * w * (w * w) if n_points == 4 else w * (w * w)
    w_n = torch.clamp_max(w_n, 1.0 - 1e-7)
    denom = torch.clamp_max(torch.log1p(-w_n), -1e-30)
    n_req = torch.log1p(-torch.tensor(confidence, dtype=f32)) / denom
    return evaluated >= torch.clamp_max(n_req, float(n_iter))


def ransac_adaptive_ref(match1, match2, valid, tolerance, n_iter, chunk, confidence,
                        seed=None, samples=None, transform="homography"):
    """Plain PyTorch. Hypotheses c * chunk .. (c + 1) * chunk of loop block
    c are drawn under `seed` (or are rows of `samples`, (ceil(n_iter /
    chunk) * chunk, n_points) int32) and scored; the running best changes only on a
    strictly larger block maximum (first index on ties), and the loop stops
    once (blocks run) * chunk >= min(n_req, n_iter). The stop test is read
    back once a block. Returns (RansacResult, n_evaluated () int32, Record
    of the hypotheses evaluated). k problems under a leading pair axis (seed
    (k,) or samples (k, rows, n_points)) are fitted pair by pair, pair p
    under seed[p:p + 1] (or samples[p]), each to its own stop, and stacked:
    n_evaluated (k,), and a pair's Record rows past its n_evaluated -1 (the
    kernel leaves them unwritten)."""
    if match1.dim() == 3:
        fits = [ransac_adaptive_ref(match1[p], match2[p], valid[p], tolerance, n_iter, chunk,
                                    confidence, None if seed is None else seed[p:p + 1],
                                    None if samples is None else samples[p], transform)
                for p in range(match1.shape[0])]
        n_rows = -(-n_iter // chunk) * chunk
        recs = [Record(*(torch.cat([x, x.new_full((n_rows - x.shape[0],) + x.shape[1:], -1)])
                         for x in f[2])) for f in fits]
        return (stack_fits([f[0] for f in fits]), torch.stack([f[1] for f in fits]),
                stack_fits(recs))
    dev = match1.device
    n_points = n_points_of(transform)
    n_valid = valid.sum(dtype=torch.int32)
    best_H = torch.eye(3, dtype=match1.dtype, device=dev)
    best_count = torch.zeros((), dtype=torch.int32, device=dev)
    best_sample = torch.zeros(n_points, dtype=torch.int32, device=dev)
    counts, sets = [], []
    for c in range(-(-n_iter // chunk)):
        block = (draw_sets_ref(valid, seed, chunk, first=c * chunk, n_points=n_points)
                 if samples is None else samples[c * chunk:(c + 1) * chunk])
        H, block_counts = ransac_score_ref(match1, match2, valid, block, tolerance, transform)
        c_best = torch.argmax(block_counts)
        if block_counts[c_best] > best_count:
            best_count, best_H, best_sample = block_counts[c_best], H[c_best], block[c_best]
        counts.append(block_counts)
        sets.append(block)
        if _chunk_done(best_count, n_valid, (c + 1) * chunk, n_iter, confidence, n_points):
            break
    inliers = winner_mask(match1, match2, valid, best_H, tolerance) & (best_count > 0)
    found = (best_count > 0) & (n_valid >= n_points)
    n_eval = torch.tensor(len(counts) * chunk, dtype=torch.int32, device=dev)
    return (RansacResult(best_H, best_count, inliers, found, best_sample), n_eval,
            Record(torch.cat(counts), torch.cat(sets)))


def ransac_adaptive(match1, match2, valid, tolerance, n_iter, chunk, confidence,
                    seed=None, samples=None, record=False, transform="homography"):
    """`ransac_adaptive_ref` for CPU tensors, one cooperative launch of the
    kernel for CUDA ones (above SHARED_ORDER_MAX matches, after the scan
    kernel that writes the valid-first order), which runs the loop, its
    stop test and the winner's mask on the device: nothing is read back,
    and blocks after the stop are never run. seed: (1,) int64 on the
    device; samples: the injected sets instead; transform: 'homography' or
    'affine'. k problems under a leading pair axis (match1, match2 (k, N,
    3), valid (k, N), seed (k,) or samples (k, rows, n_points)) are one
    launch for all k fits (at most MAX_PAIRS), the co-resident blocks split
    among the pairs, each pair evaluating exactly the blocks its own fit
    would and frozen once it stops; one problem is the kernel's k = 1, its
    outputs shaped without the pair axis. Returns (RansacResult,
    n_evaluated () or (k,), Record or None): the Record, when `record`,
    holds ceil(n_iter / chunk) * chunk rows a fit, of which the first
    n_evaluated are written. Forward only: raises when a match array
    requires grad under grad mode."""
    forbid_grad("ransac_adaptive", match1, match2)
    if match1.device.type == "cpu":
        res, n_eval, rec = ransac_adaptive_ref(match1, match2, valid, tolerance, n_iter,
                                               chunk, confidence, seed, samples, transform)
        return res, n_eval, rec if record else None
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    n_points = n_points_of(transform)
    n_chunks = -(-n_iter // chunk)
    n_rows = n_chunks * chunk
    lead, k, n, dev, order = check_matches(match1, match2, valid)
    if k > MAX_PAIRS:
        raise ValueError(f"ransac_adaptive: {k} pairs, at most {MAX_PAIRS}")
    seed_ptr, samples_ptr = draw_source(seed, samples, lead, n_rows, dev, n_points)
    H, ints, flags, res = outputs(lead, n, dev, n_points)
    rec = record_outputs(lead, n_rows, dev, n_points) if record else None
    counts_ptr, sets_ptr = (ptr(rec.counts), ptr(rec.sets)) if rec else (None, None)
    # best (k n_chunks 64-bit words), each pair's n_valid (k words, padded to
    # 16 bytes), then the slots of every hypothesis block of every pair
    n_slots = k * n_chunks * -(-chunk // HYP_PER_BLOCK)
    n_valid_words = -(-k // 4) * 4
    scratch = torch.empty(2 * k * n_chunks + n_valid_words + n_slots * SLOT_WORDS,
                          dtype=torch.int32, device=dev)
    best = ptr(scratch)
    n_valid_of = best + 8 * k * n_chunks
    KERNEL(dev, ptr(match1), ptr(match2), ptr(valid), n, k, seed_ptr, samples_ptr, n_chunks,
           chunk, n_iter, n_points, tolerance, confidence, counts_ptr, sets_ptr, ptr(H),
           ptr(ints), ptr(flags), None if order is None else ptr(order), best, n_valid_of,
           n_valid_of + 4 * n_valid_words, stream(match1))
    return res, ints[..., EVALUATED], rec
