"""Flow reconstruction and multi-homography compositing, the harnesses'
shared metric core (port of `ransacflow_tpu/eval/compose.py`).

Every reference harness rebuilds the full-resolution flow the same way
(e.g. evaluation/evalHpatch/getResults.py:16-63): warp-grid the coarse H
stack, bilinearly upsample the stride-8 fine flow, compose by sampling the
coarse grid at (flow + grid), build the matchability map, then merge the
stack per pixel, first accept. `reconstruct_flows` builds the n grids with
`ops.homography.warp_grid` and composes them in one call of kernel 8
(`kernels.compose.compose_tail`), the n homographies its batch; the merge,
the connected-component cleanup and the nearest fill are the reference's
numpy and scipy host code, copied.
"""

import numpy as np
import torch

from ransacflow_tpu_torch.device import as_device
from ransacflow_tpu_torch.kernels.compose import compose_tail
from ransacflow_tpu_torch.ops.homography import warp_grid


def put(arr, device):
    """A host array as a contiguous float32 tensor on `device`."""
    return torch.as_tensor(np.ascontiguousarray(arr, np.float32), device=device)


def match_channels(match_down8):
    """cat(match12, match21) at stride 8, (n, h8, w8, 2), as kernel 8's two
    contiguous (n, h8, w8, 1) inputs."""
    return match_down8[..., 0:1].contiguous(), match_down8[..., 1:2].contiguous()


@torch.inference_mode()
def reconstruct_flows(coarse_h, fine_flow_down8, fine_match_down8, out_h, out_w, device,
                      cycle_match=True):
    """Per-homography full-resolution flow and matchability.

    Args:
      coarse_h: (n, 3, 3) homography stack.
      fine_flow_down8: (n, h8, w8, 2) stride-8 fine flows.
      fine_match_down8: (n, h8, w8, 2) cat(match12, match21) at stride 8.
      device: where the grids are built and composed (kernel 8 on CUDA,
        its plain version on the CPU).
      cycle_match: match = match12 * match21 sampled at the flow (YFCC,
        KITTI, corr) or match12 alone (HPatches, getResults.py:44-46).
    Returns (flow, match) numpy: (n, out_h, out_w, 2) flows clipped to
    [-1, 1] and (n, out_h, out_w) matchability with the in-bounds factor.
    """
    device = as_device(device)
    grids = warp_grid(put(coarse_h, device), out_h, out_w)
    flow, match = compose_tail(put(fine_flow_down8, device),
                               *match_channels(put(fine_match_down8, device)), grids,
                               cycle_match)
    return flow.clamp(-1.0, 1.0).cpu().numpy(), match.cpu().numpy()


def merge_multi_h(flows, matches, th, multi_h=True, aggregate_match=False):
    """First-accept per-pixel merge over the homography stack
    (reference: evaluation/evalHpatch/getResults.py:53-61).

    Args:
      flows: (n, H, W, 2); matches: (n, H, W); th: acceptance threshold.
    Returns dict: 'flow' (H, W, 2), 'match_binary' (H, W) bool, and
    'match' (H, W) aggregated matchability when aggregate_match.
    """
    flow_global = flows[0].copy()
    match_binary = matches[0] >= th
    match_global = matches[0].copy() if aggregate_match else None
    if multi_h:
        for i in range(1, len(flows)):
            take = (matches[i] >= th) & (~match_binary)
            if aggregate_match:
                match_global[take] = matches[i][take]
            match_binary = match_binary | take
            flow_global[take] = flows[i][take]
    out = {"flow": flow_global, "match_binary": match_binary}
    if aggregate_match:
        out["match"] = match_global
    return out


def remove_small_cc(match, cc_th, match_th=0.99):
    """Zero connected components covering <= cc_th of the image
    (reference: evaluation/evalKITTI/evaluation.py:85-100). 8-connectivity,
    matching skimage measure.label's 2-D default."""
    if cc_th == 0:
        return match
    from scipy import ndimage

    binary = match > match_th
    labels, n = ndimage.label(binary, structure=np.ones((3, 3)))
    if n == 0:
        return match
    out = match.copy()
    sizes = ndimage.sum_labels(np.ones_like(match), labels, range(1, n + 1))
    frac = sizes / match.size
    for i in range(1, n + 1):
        if frac[i - 1] <= cc_th:
            out[labels == i] = 0
    return out


def fill_flow_nearest(flow, match_binary):
    """Fill unmatched pixels with the nearest matched pixel's flow
    (reference: evaluation/evalKITTI/getResults.py:87-93)."""
    from scipy import ndimage

    idx = ndimage.distance_transform_edt(
        ~match_binary, return_distances=False, return_indices=True
    )
    return flow[tuple(idx)]
