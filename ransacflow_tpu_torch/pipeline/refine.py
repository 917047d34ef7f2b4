"""Iterative RANSAC refinement of an estimated dense flow (port of
`ransacflow_tpu/pipeline/refine.py`, the reference's ``--iterR``).

The current composed flow is a dense set of target -> source
correspondences: gate them by matchability and in-bounds-ness, fit one more
RANSAC transform on them, warp the source under the refined transform and
run the fine stage once on top. The whole H*W grid goes in as one padded
match array with a validity mask, so at 480x640 the fit is kernel 3 over
307,200 matches (above the kernels' shared-memory order, see
`kernels/ransac.py`).
"""

import torch

from ransacflow_tpu_torch.ops.grid import normalized_grid
from ransacflow_tpu_torch.ops.homography import warp_grid
from ransacflow_tpu_torch.ops.ransac import ransac_homography
from ransacflow_tpu_torch.pipeline.fine import pred_flow_mask


@torch.inference_mode()
def refine_flow_ransac(generator, align_params, src, featt, flow_est, match_est,
                       transform="homography", n_iter=1000, tolerance=0.03, n_points=4,
                       kernel_size=7, match_th=0.5, injected_samples=None):
    """One iterative-refinement round on an estimated flow.

    generator: the `torch.Generator` of the RANSAC draws (on the device of
      the tensors).
    align_params: the alignment networks.
    src: (1, Hs, Ws, 3) source image in [0, 1].
    featt: (1, Ht/8, Wt/8, 256) L2-normalized target features
      (`pipeline.fine.fine_features`).
    flow_est: (1, Ht, Wt, 2) current composed flow (target -> source,
      normalized sampling grid).
    match_est: (Ht, Wt) or (1, Ht, Wt, 1) matchability of the estimate.
    transform / n_points: 'homography' and 4, or 'affine' and 3.
    n_iter / tolerance: RANSAC knobs; the defaults mirror the reference's
      ``iterative(..., nbIter=1000, tolerance=0.03, nbPoint=4)``.
    match_th: matchability acceptance threshold.
    injected_samples: optional (n_iter, n_points) int32 pixel indices used
      as the minimal sets instead of drawing.

    Returns the dict of `pred_flow_mask` (flow, match, flow_down8,
    match_down8) of the re-run fine stage (cycle_match off) plus refined_h
    (3, 3), the fitted transform (the identity when RANSAC found none),
    num_inliers and found.
    """
    ht, wt = flow_est.shape[1:3]
    dev = flow_est.device
    grid = normalized_grid(ht, wt, dev, flow_est.dtype)

    match = match_est.reshape(ht, wt)
    fx, fy = flow_est[0, :, :, 0], flow_est[0, :, :, 1]
    in_bounds = (fx >= -1) & (fx <= 1) & (fy >= -1) & (fy <= 1)
    valid = ((match * in_bounds.to(match.dtype)) > match_th).reshape(-1)

    ones = torch.ones((ht * wt, 1), dtype=flow_est.dtype, device=dev)
    match1 = torch.cat([flow_est[0].reshape(-1, 2), ones], dim=1)
    match2 = torch.cat([grid.reshape(-1, 2), ones], dim=1)
    res = ransac_homography(match1, match2, valid, tolerance, n_iter=n_iter,
                            generator=generator, injected_samples=injected_samples,
                            n_points=n_points, transform=transform)
    # the reference's identity when there are not enough matches; `found`
    # also covers a winner without inliers
    refined_h = torch.where(res.found, res.H21,
                            torch.eye(3, dtype=res.H21.dtype, device=dev))
    # an affine H has last row [0, 0, 1]: warp_grid is F.affine_grid of its
    # top two rows
    out = pred_flow_mask(align_params, src, featt, warp_grid(refined_h[None], ht, wt),
                         cycle_match=False, kernel_size=kernel_size)
    out["refined_h"] = refined_h
    out["num_inliers"] = res.num_inliers
    out["found"] = res.found
    return out
