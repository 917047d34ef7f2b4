"""Kernel 2: mutual-argmax epilogue of the matching score, exact or relaxed
reciprocity (`csrc/matching.cu`)."""

import ctypes

import torch

from ransacflow_tpu_torch.kernels.build import Kernel, check, forbid_grad, ptr, stream

KERNEL = Kernel("rf_mutual_argmax",
                [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 7)
MAX_SPLIT = 32  # row ranges of the column argmax; ~1200 blocks at 13k x 1200


def _check_relax(relax_cells, grid_w):
    if relax_cells < 0:
        raise ValueError(f"relax_cells={relax_cells}: must be >= 0")
    if relax_cells and grid_w is None:
        raise ValueError("relax_cells > 0 requires grid_w")


def mutual_argmax_ref(score, relax_cells=0, grid_w=None):
    """Plain PyTorch. score (nA, nB) -> (best_src (nB,) int32, best_tgt (nA,)
    int32, valid (nB,) bool, pair_score (nB,)); argmax ties go to the lowest
    index, valid = reciprocal and nonzero. Reciprocal: the back-match
    best_tgt[best_src[j]] is j, or, with relax_cells > 0, lies within that
    Chebyshev radius of j in cells of the row-major target grid of width
    grid_w."""
    _check_relax(relax_cells, grid_w)
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


def mutual_argmax(score, relax_cells=0, grid_w=None):
    """`mutual_argmax_ref` for a CPU tensor, the kernel for a CUDA one.
    Forward only: raises when `score` requires grad under grad mode."""
    forbid_grad("mutual_argmax", score)
    if score.device.type == "cpu":
        return mutual_argmax_ref(score, relax_cells, grid_w)
    _check_relax(relax_cells, grid_w)
    check(score, "score", torch.float32, ndim=2)
    n_a, n_b = score.shape
    n_split = max(1, min(MAX_SPLIT, n_a // 256))
    dev = score.device
    part_v = torch.empty((n_split, n_b), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_split, n_b), dtype=torch.int32, device=dev)
    best_src = torch.empty(n_b, dtype=torch.int32, device=dev)
    best_tgt = torch.empty(n_a, dtype=torch.int32, device=dev)
    valid = torch.empty(n_b, dtype=torch.bool, device=dev)
    pair_score = torch.empty(n_b, dtype=torch.float32, device=dev)
    KERNEL(dev, ptr(score), n_a, n_b, n_split, int(relax_cells), int(grid_w or 0),
           ptr(part_v), ptr(part_i),
           ptr(best_src), ptr(best_tgt), ptr(valid), ptr(pair_score),
           stream(score))
    return best_src, best_tgt, valid, pair_score
