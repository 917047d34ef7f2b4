"""Kernel 2: mutual-argmax epilogue of the matching score, exact or relaxed
reciprocity, with the target mask folded in (`csrc/matching.cu`). One
wrapper takes one score (nA, nB) or k scores (k, nA, nB), the pair axis read
from the score's rank; k scores are one launch."""

import ctypes

import torch

from ransacflow_tpu_torch.kernels.build import (
    Kernel,
    check,
    forbid_grad,
    ptr,
    stream,
    upcast,
)

KERNEL = Kernel("rf_mutual_argmax",
                [ctypes.c_void_p] * 2 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 6)
MAX_SLICE = 1280     # kMaxSlice: columns of a chunk block's slice
BLOCKS_PER_SM = 2    # chunk blocks resident on an SM (the source's launch bounds)
ROW_WARPS = 8        # kWarps: rows a chunk block takes at a time
_sm_count = {}       # device -> multiprocessors


def _check_relax(relax_cells, grid_w):
    if relax_cells < 0:
        raise ValueError(f"relax_cells={relax_cells}: must be >= 0")
    if relax_cells and grid_w is None:
        raise ValueError("relax_cells > 0 requires grid_w")


def mutual_argmax_ref(score, relax_cells=0, grid_w=None, valid_b=None):
    """Plain PyTorch. score (nA, nB) and an optional (nB,) mask `valid_b`
    (the score taken as score * valid_b, as the reference takes it) ->
    (best_src (nB,) int32, best_tgt (nA,) int32, valid (nB,) bool,
    pair_score (nB,)); a (k, nA, nB) score with a (k, nB) mask gives each
    output a leading pair axis, pair p's those of its own score. Argmax ties
    go to the lowest index, valid = reciprocal and nonzero. Reciprocal: the
    back-match best_tgt[best_src[j]] is j, or, with relax_cells > 0, lies
    within that Chebyshev radius of j in cells of the row-major target grid
    of width grid_w."""
    _check_relax(relax_cells, grid_w)
    if valid_b is not None:
        score = score * valid_b.to(score.dtype).unsqueeze(-2)
    best_src = torch.argmax(score, dim=-2)
    best_tgt = torch.argmax(score, dim=-1)
    cols = torch.arange(score.shape[-1], device=score.device)
    pair_score = score.gather(-2, best_src.unsqueeze(-2)).squeeze(-2)
    back = best_tgt.gather(-1, best_src)
    if relax_cells:
        d_row = (back // grid_w - cols // grid_w).abs()
        d_col = (back % grid_w - cols % grid_w).abs()
        mutual = torch.maximum(d_row, d_col) <= relax_cells
    else:
        mutual = back == cols
    valid = mutual & (pair_score != 0.0)
    return (best_src.to(torch.int32), best_tgt.to(torch.int32), valid,
            pair_score)


def schedule(n_a, n_b, vec, n_sm, n_pairs=1):
    """The kernel's blocks for each of `n_pairs` scores: (n_chunks,
    rows_per_block, n_slices, slice_w). The columns split into the fewest
    slices of at most MAX_SLICE (a multiple of 4 with 16-byte loads), the
    rows into chunks so that the grid of all pairs is about one wave of
    BLOCKS_PER_SM blocks an SM, each chunk at least ROW_WARPS rows."""
    n_slices = -(-n_b // MAX_SLICE)
    slice_w = -(-n_b // n_slices)
    if vec:
        slice_w = -(-slice_w // 4) * 4
    n_chunks = max(1, min(-(-n_a // ROW_WARPS),
                          BLOCKS_PER_SM * n_sm // (n_slices * n_pairs)))
    rows_per_block = -(-n_a // n_chunks)
    return -(-n_a // rows_per_block), rows_per_block, n_slices, slice_w


def _multiprocessors(device):
    if device not in _sm_count:
        _sm_count[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sm_count[device]


def mutual_argmax(score, relax_cells=0, grid_w=None, valid_b=None):
    """`mutual_argmax_ref` for a CPU tensor, the kernel for a CUDA one: the
    raw score is read once, `valid_b` (bool) applied per element as it is
    read; two launches, nothing read back. k scores (k, nA, nB) with their
    optional (k, nB) masks take the kernel's two launches for all k pairs,
    each pair's outputs bit for bit its own call's; one score is the
    kernel's k = 1, its outputs shaped without the pair axis. The limits are
    per pair: fewer than 2^31 score elements. Forward only: raises when
    `score` requires grad under grad mode."""
    forbid_grad("mutual_argmax", score)
    if score.dim() not in (2, 3):
        raise ValueError(f"mutual_argmax: score of shape {tuple(score.shape)}, expected "
                         "(nA, nB) or (k, nA, nB)")
    dtype = score.dtype
    (score,) = upcast(score)  # exact: every tie stays a tie
    if score.device.type == "cpu":
        best_src, best_tgt, valid, pair_score = mutual_argmax_ref(score, relax_cells, grid_w,
                                                                  valid_b)
        return best_src, best_tgt, valid, pair_score.to(dtype)
    _check_relax(relax_cells, grid_w)
    check(score, "score", torch.float32)
    lead = tuple(score.shape[:-2])
    n_pairs = lead[0] if lead else 1
    n_a, n_b = score.shape[-2:]
    dev = score.device
    if valid_b is not None:
        check(valid_b, "valid_b", torch.bool, shape=lead + (n_b,), device=dev)
    if n_a * n_b >= 2**31 or n_pairs > 65535:
        raise ValueError("mutual_argmax: a score must hold fewer than 2^31 elements, "
                         "and a batch at most 65535 of them")
    vec = n_b % 4 == 0 and ptr(score) % 16 == 0  # 16-byte loads of the score
    n_chunks, rows_per_block, n_slices, slice_w = schedule(n_a, n_b, vec,
                                                           _multiprocessors(dev), n_pairs)
    keys = torch.empty(n_pairs * (n_chunks * n_b + (n_a * n_slices if n_slices > 1 else 0)),
                       dtype=torch.int64, device=dev)
    idx = torch.empty(n_pairs * (n_b + n_a), dtype=torch.int32, device=dev)
    best_src, best_tgt = idx[:n_pairs * n_b], idx[n_pairs * n_b:]
    if lead:
        best_src, best_tgt = best_src.view(n_pairs, n_b), best_tgt.view(n_pairs, n_a)
    # shapes as separate ints: PyTorch parses a tuple argument more slowly
    valid = torch.empty(*lead, n_b, dtype=torch.bool, device=dev)
    pair_score = torch.empty(*lead, n_b, dtype=torch.float32, device=dev)
    KERNEL(dev, ptr(score), None if valid_b is None else ptr(valid_b), n_a, n_b, n_pairs,
           n_chunks, rows_per_block, n_slices, slice_w, int(vec), int(relax_cells),
           int(grid_w or 0), ptr(keys), ptr(best_src), ptr(best_tgt), ptr(valid),
           ptr(pair_score), stream(score))
    return best_src, best_tgt, valid, pair_score.to(dtype)
