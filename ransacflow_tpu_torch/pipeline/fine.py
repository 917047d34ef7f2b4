"""Fine alignment: warp -> features -> correlation -> flow + matchability
(port of `ransacflow_tpu/pipeline/fine.py:25-106`).

`params` is the dict of the three alignment networks: 'netFeatCoarse',
'netFlowCoarse', 'netMatch' (see `pipeline.init_alignment_params`). The
source warp is kernel 5 (on the alignment paths its homography form, which
also writes the coarse grid), the correlations kernel 6, the head
epilogues kernel 7 and the compose tail kernel 8.
"""

import torch

from ransacflow_tpu_torch.kernels.compose import compose_tail
from ransacflow_tpu_torch.kernels.correlation import correlation_volume
from ransacflow_tpu_torch.kernels.warp_sample import warp_homography, warp_sample
from ransacflow_tpu_torch.models.feature_extractor import feature_extractor
from ransacflow_tpu_torch.models.heads import net_flow_coarse, net_matchability
from ransacflow_tpu_torch.models.layers import l2_normalize


@torch.inference_mode()
def pred_flow_mask(params, src, featt, flow_coarse, cycle_match=False,
                   kernel_size=7):
    """Fine stage for one coarse hypothesis.

    src: (1, Hs, Ws, 3) source in [0, 1]; featt: (1, Ht/8, Wt/8, 256)
    L2-normalized target fine features; flow_coarse: (1, Ht, Wt, 2) coarse
    sampling grid (target -> source); cycle_match: multiply match12 by the
    back-warped match21.

    Returns dict: flow (1, Ht, Wt, 2) composed grid, match (Ht, Wt),
    flow_down8 (1, Ht/8, Wt/8, 2), match_down8 (1, Ht/8, Wt/8, 2).
    """
    return _after_warp(params, warp_sample(src, flow_coarse), featt, flow_coarse,
                       cycle_match, kernel_size)


@torch.inference_mode()
def pred_flow_mask_homography(params, src, featt, H, out_hw, cycle_match=False,
                              kernel_size=7):
    """`pred_flow_mask` at the grid `warp_grid(H, *out_hw)`, the warp and
    that grid from one launch of kernel 5 (`warp_homography`).

    H: (1, 3, 3) homography (target -> source normalized coordinates) on
    the device of `src`; out_hw: the target's (Ht, Wt). Returns the dict of
    `pred_flow_mask` and 'warped', the warped source (1, Ht, Wt, 3).
    """
    src_warp, flow_coarse = warp_homography(src, H, out_hw)
    out = _after_warp(params, src_warp, featt, flow_coarse, cycle_match, kernel_size)
    out["warped"] = src_warp
    return out


def _after_warp(params, src_warp, featt, flow_coarse, cycle_match, kernel_size):
    """The fine stage from the warped source on (features, correlations,
    heads, compose tail)."""
    feats = l2_normalize(feature_extractor(params["netFeatCoarse"], src_warp))

    corr12 = correlation_volume(featt, feats, kernel_size)
    flow_down8 = net_flow_coarse(params["netFlowCoarse"], corr12, up8=False,
                                 kernel_size=kernel_size)
    match12_down8 = net_matchability(params["netMatch"], corr12, up8=False)
    corr21 = correlation_volume(feats, featt, kernel_size)
    match21_down8 = net_matchability(params["netMatch"], corr21, up8=False)

    flow12, match = compose_tail(flow_down8, match12_down8, match21_down8,
                                 flow_coarse, cycle_match)
    return {
        "flow": flow12,
        "match": match[0],
        "flow_down8": flow_down8,
        "match_down8": torch.cat([match12_down8, match21_down8], dim=-1),
    }


@torch.inference_mode()
def fine_features(params, img):
    """L2-normalized fine features (1, H/8, W/8, 256) of (1, H, W, 3)."""
    return l2_normalize(feature_extractor(params["netFeatCoarse"], img))
