"""Dense mutual nearest-neighbour matching, keyed by target cell (port of
`ransacflow_tpu/ops/matching.py:24-74`).

The score GEMM is `torch.matmul`; its argmax/reciprocity epilogue is kernel 2
(`kernels/matching.py`). bf16 banks (the eval policy) give an fp32 score, as
the reference's `preferred_element_type=float32` does (`:53`). With exact
reciprocity a source cell matches at most one target cell; with
`relax_cells > 0` several target cells may keep the same source cell.
`mutual_matching` of k pairs' banks makes their scores one `torch.bmm` and
their epilogues one launch of kernel 2.
"""

from typing import NamedTuple

import torch

from ransacflow_tpu_torch.kernels.matching import mutual_argmax, mutual_argmax_ref


class MatchResult(NamedTuple):
    """Mutual matches keyed by target cell (all (nB,), or (k, nB) for a
    batch)."""

    src_idx: torch.Tensor  # best source cell per target cell, int32
    valid: torch.Tensor    # True where the pair is a mutual argmax
    score: torch.Tensor    # score of the pair


def score_gemm(featA, featB):
    """The cosine score ``featA^T featB``: (nA, nB) of one pair's (C, nA)
    and (C, nB) banks, or (k, nA, nB) of k pairs' (k, C, nA) and (k, C, nB)
    banks in one `torch.bmm`. bf16 banks: bf16 products (exact in fp32)
    summed in fp32 to an fp32 score, on the card by cuBLAS's bf16 GEMM with
    an fp32 output."""
    a = featA.transpose(-2, -1)
    if featA.dtype != torch.bfloat16:
        return a @ featB
    if featA.device.type == "cuda":
        return (torch.mm if a.dim() == 2 else torch.bmm)(a, featB, out_dtype=torch.float32)
    return a.float() @ featB.float()


def mutual_matching(featA, featB, validB=None, relax_cells=0, grid_w=None):
    """Mutual NN matching between L2-normalized banks featA (C, nA) and
    featB (C, nB). A pair (i, j) is kept iff i is the argmax of column j, j
    the argmax of row i, and the score is nonzero; ties go to the lowest
    index. Masked target cells (validB False) score 0: the (nB,) bool mask
    goes to the epilogue with the raw score, which applies it as it reads
    (no pass of its own over the score).

    relax_cells > 0 (the anchor mode's companion): the back-match of j may
    land within this Chebyshev radius of j, in cells of the row-major target
    grid of width grid_w (required then). As in the reference, a back-match
    on a masked cell (score 0, when every unmasked score of the source row
    is negative) still validates its unmasked neighbours.

    k pairs at once: featA (k, C, nA), featB (k, C, nB) and a (k, nB) mask
    give a MatchResult of (k, nB) fields, the scores one `torch.bmm` and
    their epilogue one launch of kernel 2; pair p's matches are those of
    its banks alone.
    """
    best_src, _, valid, pair_score = mutual_argmax(score_gemm(featA, featB), relax_cells,
                                                   grid_w, validB)
    return MatchResult(best_src, valid, pair_score)


def mutual_matching_ref(featA, featB, validB=None, relax_cells=0, grid_w=None):
    """`mutual_matching` through the plain epilogue, on any device, the
    score multiplied by the mask first."""
    best_src, _, valid, pair_score = mutual_argmax_ref(score_gemm(featA, featB), relax_cells,
                                                       grid_w, validB)
    return MatchResult(best_src, valid, pair_score)
