"""Fine alignment: warp -> features -> correlation -> flow + matchability
(port of `ransacflow_tpu/pipeline/fine.py:25-106`).

`params` is the dict of the three alignment networks: 'netFeatCoarse',
'netFlowCoarse', 'netMatch' (see `pipeline.init_alignment_params`). The
source warp is kernel 5 (on the alignment paths its homography form, which
also writes the coarse grid), both correlations one launch of kernel 6's
pair form, the three head epilogues one launch of kernel 7 and the compose
tail kernel 8.
"""

import torch

from ransacflow_tpu_torch.kernels.compose import compose_tail
from ransacflow_tpu_torch.kernels.correlation import correlation_pair
from ransacflow_tpu_torch.kernels.heads import head_epilogues
from ransacflow_tpu_torch.kernels.warp_sample import warp_homography, warp_sample
from ransacflow_tpu_torch.models.feature_extractor import feature_extractor
from ransacflow_tpu_torch.models.heads import head_logits
from ransacflow_tpu_torch.models.layers import l2_normalize


@torch.inference_mode()
def pred_flow_mask(params, src, featt, flow_coarse, cycle_match=False,
                   kernel_size=7, out_hw=None):
    """Fine stage for one coarse hypothesis.

    src: (1, Hs, Ws, 3) source in [0, 1]; featt: (1, Ht/8, Wt/8, 256)
    L2-normalized target fine features; flow_coarse: (1, Ht, Wt, 2) coarse
    sampling grid (target -> source); cycle_match: multiply match12 by the
    back-warped match21; out_hw: optional (H, W) to upsample and compose
    at instead of the coarse grid's (KITTI composes its second pass at the
    ground truth's size while warping at fineSize).

    Returns dict: flow (1, H, W, 2) composed grid, match (H, W),
    flow_down8 (1, Ht/8, Wt/8, 2), match_down8 (1, Ht/8, Wt/8, 2); (H, W)
    is out_hw, else (Ht, Wt).
    """
    out = _after_warp(params, warp_sample(src, flow_coarse), featt, flow_coarse,
                      cycle_match, kernel_size, out_hw)
    out["match"] = out["match"][0]
    return out


@torch.inference_mode()
def pred_flow_mask_homography(params, src, featt, H, out_hw, cycle_match=False,
                              kernel_size=7):
    """`pred_flow_mask` at the grid `warp_grid(H, *out_hw)`, the warp and
    that grid from one launch of kernel 5 (`warp_homography`), for B pairs
    at once (B = 1 on the single-pair paths).

    src: (B, Hs, Ws, 3); featt: (B, Ht/8, Wt/8, 256); H: (B, 3, 3)
    homographies (target -> source normalized coordinates) on the device of
    `src`; out_hw: the target's (Ht, Wt), the size of the warp grid, at
    which the flow is also composed (not `pred_flow_mask`'s optional
    compose size). Returns the dict of `pred_flow_mask` with the batch axis
    kept on every entry (match (B, Ht, Wt)) and 'warped', the warped source
    (B, Ht, Wt, 3).
    """
    src_warp, flow_coarse = warp_homography(src, H, out_hw)
    out = _after_warp(params, src_warp, featt, flow_coarse, cycle_match, kernel_size)
    out["warped"] = src_warp
    return out


def _after_warp(params, src_warp, featt, flow_coarse, cycle_match, kernel_size,
                out_hw=None):
    """The fine stage from the warped source on (features, correlations,
    heads, compose tail at `out_hw`, else at the grid's size), for a batch:
    match is (B, H, W)."""
    feats = l2_normalize(feature_extractor(params["netFeatCoarse"], src_warp))

    # corr12 = corr(featt, feats) and corr21 = corr(feats, featt), one launch
    corr12, corr21 = correlation_pair(featt, feats, kernel_size)
    # the three heads' trunks, then their epilogues in one launch
    flow_down8, match12_down8, match21_down8, match_down8 = head_epilogues(
        head_logits(params["netFlowCoarse"], corr12),
        head_logits(params["netMatch"], corr12),
        head_logits(params["netMatch"], corr21), kernel_size)

    flow12, match = compose_tail(flow_down8, match12_down8, match21_down8,
                                 flow_coarse, cycle_match, out_hw)
    return {
        "flow": flow12,
        "match": match,
        "flow_down8": flow_down8,
        "match_down8": match_down8,
    }


@torch.inference_mode()
def fine_features(params, img):
    """L2-normalized fine features (1, H/8, W/8, 256) of (1, H, W, 3)."""
    return l2_normalize(feature_extractor(params["netFeatCoarse"], img))
