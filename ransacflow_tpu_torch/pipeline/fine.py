"""Fine alignment: warp -> features -> correlation -> flow + matchability
(port of `ransacflow_tpu/pipeline/fine.py:25-106`).

`params` is the dict of the three alignment networks: 'netFeatCoarse',
'netFlowCoarse', 'netMatch' (see `pipeline.init_alignment_params`). The
source warp is kernel 5, the correlations kernel 6, the head epilogues
kernel 7 and the compose tail kernel 8.
"""

import torch

from ransacflow_tpu_torch.kernels.compose import compose_tail
from ransacflow_tpu_torch.kernels.correlation import correlation_volume
from ransacflow_tpu_torch.kernels.warp_sample import warp_sample
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
    src_warp = warp_sample(src, flow_coarse)
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
