"""The serving path: one pair aligned on the device with no host round trip
(port of `ransacflow_tpu/pipeline/fused.py`, exact mode, fixed-count RANSAC).

Multi-scale coarse features -> mutual matching -> RANSAC -> homography warp
-> fine stage. `fused_align_batch` runs pairs one after another (the
reference's 'scan' batch mode). The pyramid is kernel 1
(`kernels/pyramid.device_pyramid`, re-exported here).
"""

import torch

from ransacflow_tpu_torch.kernels.pyramid import device_pyramid  # noqa: F401  (K1)
from ransacflow_tpu_torch.models.layers import l2_normalize
from ransacflow_tpu_torch.models.resnet50 import imagenet_preprocess, resnet50_layer3
from ransacflow_tpu_torch.ops.grid import feature_cell_coords
from ransacflow_tpu_torch.ops.homography import warp_grid
from ransacflow_tpu_torch.ops.matching import mutual_matching
from ransacflow_tpu_torch.ops.ransac import ransac_homography
from ransacflow_tpu_torch.pipeline.fine import fine_features, pred_flow_mask


def _bank_coords(pyramid_shapes, device, stride=16):
    """(nA, 2) (x, y) cell coords of a pyramid's feature bank."""
    xs, ys = [], []
    for h, w in pyramid_shapes:
        y, x = feature_cell_coords(h // stride, w // stride, device)
        xs.append(x)
        ys.append(y)
    return torch.stack([torch.cat(xs), torch.cat(ys)], dim=1)


def _coarse_features(resnet, img):
    """(1, H/16, W/16, 1024) L2-normalized trunk features of (1, H, W, 3)."""
    return l2_normalize(resnet50_layer3(resnet, imagenet_preprocess(img)))


def _coarse_match(resnet, pyramid, target):
    """Coarse features and mutual matching for one pair.

    Returns (m1, m2, valid): homogeneous (nB, 3) match arrays keyed by target
    cell, invalid rows masked by valid (nB,).
    """
    device = target.device
    bank = torch.cat([_coarse_features(resnet, img).flatten(0, 2) for img in pyramid])
    coords_a = _bank_coords([img.shape[1:3] for img in pyramid], device)
    ft = _coarse_features(resnet, target)
    featt = ft.flatten(0, 2)
    y, x = feature_cell_coords(ft.shape[1], ft.shape[2], device)
    coords_b = torch.stack([x, y], dim=1)
    m = mutual_matching(bank.T, featt.T)
    ones = torch.ones((coords_b.shape[0], 1), dtype=coords_b.dtype, device=device)
    m1 = torch.cat([coords_a[m.src_idx.long()], ones], dim=1)
    m2 = torch.cat([coords_b, ones], dim=1)
    return m1, m2, m.valid


def _fine_with_gate(align, pyramid, target, res, cycle_match, kernel_size):
    """Fine stage, gated on RANSAC failure: identity replaces a failed H21
    before the warp, matchability is zeroed, and the flows become no-ops."""
    ht, wt = target.shape[1:3]
    eye = torch.eye(3, dtype=res.H21.dtype, device=res.H21.device)
    h_used = torch.where(res.found, res.H21, eye)
    flow_coarse = warp_grid(h_used[None], ht, wt)
    src = pyramid[len(pyramid) // 2]
    out = pred_flow_mask(align, src, fine_features(align, target), flow_coarse,
                         cycle_match=cycle_match, kernel_size=kernel_size)
    foundf = res.found.to(out["match"].dtype)
    return {
        "H21": h_used,
        "found": res.found,
        "num_inliers": res.num_inliers,
        # an absolute sampling grid: the identity grid is its no-op
        "flow": torch.where(res.found, out["flow"], warp_grid(eye[None], ht, wt)),
        "match": out["match"] * foundf,
        # the raw stride-8 residual: zeros are its no-op
        "flow_down8": out["flow_down8"] * foundf,
        "match_down8": out["match_down8"] * foundf,
    }


@torch.inference_mode()
def fused_align(resnet, align, pyramid, target, generator=None, tolerance=0.05,
                n_iter=10000, kernel_size=7, cycle_match=True,
                injected_samples=None):
    """Align one pair on the device of its tensors.

    resnet: `ResNet50Layer3`; align: the alignment networks
      (`pipeline.init_alignment_params`), all on that device, in eval mode.
    pyramid: tuple of (1, Hi, Wi, 3) source scales (the middle one is warped
      by the fine stage); target: (1, Ht, Wt, 3).
    generator: `torch.Generator` on that device for the RANSAC draws.
    injected_samples: optional (n_iter, 4) RANSAC minimal sets (match indices)
      used instead of drawing.

    Returns dict: 'H21' (3, 3), 'found' (), 'num_inliers' (), 'flow'
    (1, Ht, Wt, 2), 'match' (Ht, Wt), 'flow_down8', 'match_down8'.
    """
    m1, m2, valid = _coarse_match(resnet, pyramid, target)
    res = ransac_homography(m1, m2, valid, tolerance, n_iter=n_iter,
                            generator=generator,
                            injected_samples=injected_samples)
    return _fine_with_gate(align, pyramid, target, res, cycle_match, kernel_size)


@torch.inference_mode()
def fused_align_batch(resnet, align, pyramids, targets, generator=None,
                      tolerance=0.05, n_iter=10000, kernel_size=7,
                      cycle_match=True):
    """`fused_align` over K pairs, one after another.

    pyramids: tuple of (K, 1, Hi, Wi, 3) stacked scales; targets:
    (K, 1, Ht, Wt, 3). The pairs draw from `generator` in turn. Returns the
    dict of `fused_align` with a leading K axis.
    """
    outs = [fused_align(resnet, align, tuple(p[k] for p in pyramids), targets[k],
                        generator, tolerance, n_iter, kernel_size, cycle_match)
            for k in range(targets.shape[0])]
    return {key: torch.stack([o[key] for o in outs]) for key in outs[0]}
