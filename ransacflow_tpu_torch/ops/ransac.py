"""Fixed-count RANSAC homography over padded match arrays (port of
`ransacflow_tpu/ops/ransac.py:54-185`, 'homography' with the |det| gate).

Sampling stays on the device: indices are drawn from an explicit
`torch.Generator` in the valid-first order, and `n_valid` is never read back
to the host. Solve and score is kernel 3 (`kernels/ransac.py`), which holds
no N x n_iter intermediate; the argmax (first index on ties) and the
winner's inlier mask are plain torch.
"""

from typing import NamedTuple

import torch

from ransacflow_tpu_torch.kernels.ransac import ransac_score
from ransacflow_tpu_torch.ops.homography import reprojection_error

N_POINTS = 4


class RansacResult(NamedTuple):
    H21: torch.Tensor          # (3, 3) best model (target -> source)
    num_inliers: torch.Tensor  # () int32
    inlier_mask: torch.Tensor  # (N,) bool over the padded match arrays
    found: torch.Tensor        # () bool: num_inliers > 0 and enough matches
    best_sample: torch.Tensor  # (4,) match indices of the winning set


def sample_minimal_sets(valid, n_iter, generator, n_points=N_POINTS):
    """(n_iter, n_points) int32 match indices drawn uniformly from the valid
    matches, with replacement (sets with a repeated index are rejected by
    the scorer).

    Index r of the stable valid-first order `argsort(~valid)` is drawn as
    floor(u * max(n_valid, 1)) from uniform u, so the bound stays a device
    tensor.
    """
    order = torch.argsort((~valid).to(torch.uint8), stable=True)
    bound = valid.sum().clamp_min(1)
    u = torch.rand((n_iter, n_points), generator=generator, device=valid.device)
    raw = torch.minimum((u * bound).floor().long(), bound - 1)
    return order[raw].to(torch.int32)


def ransac_homography(match1, match2, valid, tolerance, n_iter=10000,
                      generator=None, injected_samples=None):
    """RANSAC over match1, match2 (N, 3) homogeneous points and valid (N,).

    tolerance: inlier threshold in normalized [-1, 1] units.
    generator: the `torch.Generator` the minimal sets are drawn from (on the
      matches' device).
    injected_samples: optional (n_iter, 4) int32 match indices used instead of
      drawing, so that a test can feed the reference's draws.

    Returns RansacResult.
    """
    if injected_samples is None:
        samples = sample_minimal_sets(valid, n_iter, generator)
    else:
        samples = injected_samples.to(device=match1.device, dtype=torch.int32)
        if samples.shape[1] != N_POINTS or bool(
                ((samples < 0) | (samples >= match1.shape[0])).any()):
            raise ValueError("injected_samples must be (n_iter, 4) indices in [0, N)")
    H21, counts = ransac_score(match1, match2, valid, samples.contiguous(), tolerance)
    best = torch.argmax(counts)
    best_H = H21[best]
    inliers = (reprojection_error(match1, match2, best_H[None])[0] < tolerance) & valid
    n_inl = counts[best]
    found = (n_inl > 0) & (valid.sum() >= N_POINTS)
    return RansacResult(best_H, n_inl, inliers, found, samples[best])
