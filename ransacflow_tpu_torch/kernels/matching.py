"""Kernel 2: mutual-argmax epilogue of the matching score, exact or relaxed
reciprocity, with the target mask folded in (`csrc/matching.cu`)."""

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
                [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 6)
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
    pair_score (nB,)); argmax ties go to the lowest index, valid =
    reciprocal and nonzero. Reciprocal: the back-match best_tgt[best_src[j]]
    is j, or, with relax_cells > 0, lies within that Chebyshev radius of j in
    cells of the row-major target grid of width grid_w."""
    _check_relax(relax_cells, grid_w)
    if valid_b is not None:
        score = score * valid_b.to(score.dtype)[None, :]
    best_src = torch.argmax(score, dim=0)
    best_tgt = torch.argmax(score, dim=1)
    cols = torch.arange(score.shape[1], device=score.device)
    pair_score = score[best_src, cols]
    back = best_tgt[best_src]
    if relax_cells:
        d_row = (back // grid_w - cols // grid_w).abs()
        d_col = (back % grid_w - cols % grid_w).abs()
        mutual = torch.maximum(d_row, d_col) <= relax_cells
    else:
        mutual = back == cols
    valid = mutual & (pair_score != 0.0)
    return (best_src.to(torch.int32), best_tgt.to(torch.int32), valid,
            pair_score)


def schedule(n_a, n_b, vec, n_sm):
    """The kernel's blocks: (n_chunks, rows_per_block, n_slices, slice_w).
    The columns split into the fewest slices of at most MAX_SLICE (a
    multiple of 4 with 16-byte loads), the rows into chunks so that the
    grid is about one wave of BLOCKS_PER_SM blocks an SM, each chunk at
    least ROW_WARPS rows."""
    n_slices = -(-n_b // MAX_SLICE)
    slice_w = -(-n_b // n_slices)
    if vec:
        slice_w = -(-slice_w // 4) * 4
    n_chunks = max(1, min(-(-n_a // ROW_WARPS), BLOCKS_PER_SM * n_sm // n_slices))
    rows_per_block = -(-n_a // n_chunks)
    return -(-n_a // rows_per_block), rows_per_block, n_slices, slice_w


def _multiprocessors(device):
    if device not in _sm_count:
        _sm_count[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sm_count[device]


def mutual_argmax(score, relax_cells=0, grid_w=None, valid_b=None):
    """`mutual_argmax_ref` for a CPU tensor, the kernel for a CUDA one: the
    raw score is read once, `valid_b` (bool) applied per element as it is
    read; two launches, nothing read back. Forward only: raises when
    `score` requires grad under grad mode."""
    forbid_grad("mutual_argmax", score)
    dtype = score.dtype
    (score,) = upcast(score)  # exact: every tie stays a tie
    if score.device.type == "cpu":
        best_src, best_tgt, valid, pair_score = mutual_argmax_ref(score, relax_cells,
                                                                   grid_w, valid_b)
        return best_src, best_tgt, valid, pair_score.to(dtype)
    _check_relax(relax_cells, grid_w)
    check(score, "score", torch.float32, ndim=2)
    n_a, n_b = score.shape
    dev = score.device
    if valid_b is not None:
        check(valid_b, "valid_b", torch.bool, shape=(n_b,), device=dev)
    if score.numel() >= 2**31:
        raise ValueError("mutual_argmax: the score must hold fewer than 2^31 elements")
    vec = n_b % 4 == 0 and ptr(score) % 16 == 0  # 16-byte loads of the score
    n_chunks, rows_per_block, n_slices, slice_w = schedule(n_a, n_b, vec,
                                                           _multiprocessors(dev))
    keys = torch.empty(n_chunks * n_b + (n_a * n_slices if n_slices > 1 else 0),
                       dtype=torch.int64, device=dev)
    idx = torch.empty(n_b + n_a, dtype=torch.int32, device=dev)
    best_src, best_tgt = idx[:n_b], idx[n_b:]
    valid = torch.empty(n_b, dtype=torch.bool, device=dev)
    pair_score = torch.empty(n_b, dtype=torch.float32, device=dev)
    KERNEL(dev, ptr(score), None if valid_b is None else ptr(valid_b), n_a, n_b,
           n_chunks, rows_per_block, n_slices, slice_w, int(vec), int(relax_cells),
           int(grid_w or 0), ptr(keys), ptr(best_src), ptr(best_tgt), ptr(valid),
           ptr(pair_score), stream(score))
    return best_src, best_tgt, valid, pair_score.to(dtype)
