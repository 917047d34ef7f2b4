"""Dense mutual nearest-neighbour matching, keyed by target cell (port of
`ransacflow_tpu/ops/matching.py:24-74`).

The score GEMM is `torch.matmul`; its argmax/reciprocity epilogue is kernel 2
(`kernels/matching.py`). With exact reciprocity a source cell matches at
most one target cell; with `relax_cells > 0` several target cells may keep
the same source cell.
"""

from typing import NamedTuple

import torch

from ransacflow_tpu_torch.kernels.matching import mutual_argmax, mutual_argmax_ref


class MatchResult(NamedTuple):
    """Mutual matches keyed by target cell (all (nB,))."""

    src_idx: torch.Tensor  # best source cell per target cell, int32
    valid: torch.Tensor    # True where the pair is a mutual argmax
    score: torch.Tensor    # score of the pair


def _score(featA, featB, validB):
    score = featA.T @ featB  # (nA, nB)
    if validB is not None:
        score = score * validB.to(score.dtype)[None, :]
    return score


def mutual_matching(featA, featB, validB=None, relax_cells=0, grid_w=None):
    """Mutual NN matching between L2-normalized banks featA (C, nA) and
    featB (C, nB). A pair (i, j) is kept iff i is the argmax of column j, j
    the argmax of row i, and the score is nonzero; ties go to the lowest
    index. Masked target cells (validB False) score 0.

    relax_cells > 0 (the anchor mode's companion): the back-match of j may
    land within this Chebyshev radius of j, in cells of the row-major target
    grid of width grid_w (required then). As in the reference, a back-match
    on a masked cell (score 0, when every unmasked score of the source row
    is negative) still validates its unmasked neighbours.
    """
    best_src, _, valid, pair_score = mutual_argmax(_score(featA, featB, validB),
                                                   relax_cells, grid_w)
    return MatchResult(best_src, valid, pair_score)


def mutual_matching_ref(featA, featB, validB=None, relax_cells=0, grid_w=None):
    """`mutual_matching` through the plain epilogue, on any device."""
    best_src, _, valid, pair_score = mutual_argmax_ref(_score(featA, featB, validB),
                                                       relax_cells, grid_w)
    return MatchResult(best_src, valid, pair_score)
