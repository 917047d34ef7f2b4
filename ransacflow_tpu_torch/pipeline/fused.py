"""The serving path: one pair aligned on the device with no host round trip
(port of `ransacflow_tpu/pipeline/fused.py`).

Multi-scale coarse features -> mutual matching -> RANSAC -> homography warp
-> fine stage. `fused_align_batch` runs pairs one after another (the
reference's 'scan' batch mode). The pyramid is kernel 1
(`kernels/pyramid.device_pyramid`, re-exported here). The opt-in fast
modes: `anchor_stride` (the trunk at every k-th scale only, the other
scales' bank rows resampled from the nearest anchor by kernel 12),
`relax_cells` (relaxed reciprocity in kernel 2) and `adaptive_chunk`
(adaptive RANSAC, kernel 4). Their defaults are the reference's exact mode.
"""

import torch

from ransacflow_tpu_torch.kernels.pyramid import device_pyramid  # noqa: F401  (K1)
from ransacflow_tpu_torch.ops.grid import feature_cell_coords, normalized_grid
from ransacflow_tpu_torch.ops.matching import mutual_matching
from ransacflow_tpu_torch.ops.ransac import ransac_homography, ransac_homography_adaptive
from ransacflow_tpu_torch.pipeline.bank import anchor_bank, bank_coords, coarse_features
from ransacflow_tpu_torch.pipeline.fine import fine_features, pred_flow_mask_homography


def _coarse_match(resnet, pyramid, target, anchor_stride=0, relax_cells=0):
    """Coarse features and mutual matching for one pair.

    anchor_stride > 0: the anchor-pyramid bank (`pipeline.bank.anchor_bank`);
    relax_cells > 0: relaxed reciprocity over the target grid.

    Returns (m1, m2, valid): homogeneous (nB, 3) match arrays keyed by target
    cell, invalid rows masked by valid (nB,).
    """
    device = target.device
    if anchor_stride:
        bank = anchor_bank(resnet, pyramid, anchor_stride)
    else:
        bank = torch.cat([coarse_features(resnet, img).flatten(0, 2) for img in pyramid])
    coords_a = bank_coords([img.shape[1:3] for img in pyramid], device)
    ft = coarse_features(resnet, target)
    featt = ft.flatten(0, 2)
    y, x = feature_cell_coords(ft.shape[1], ft.shape[2], device)
    coords_b = torch.stack([x, y], dim=1)
    m = mutual_matching(bank.T, featt.T, relax_cells=relax_cells, grid_w=ft.shape[2])
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
    src = pyramid[len(pyramid) // 2]
    out = pred_flow_mask_homography(align, src, fine_features(align, target),
                                    h_used[None], (ht, wt), cycle_match=cycle_match,
                                    kernel_size=kernel_size)
    foundf = res.found.to(out["match"].dtype)
    return {
        "H21": h_used,
        "found": res.found,
        "num_inliers": res.num_inliers,
        # an absolute sampling grid: the identity grid is its no-op
        "flow": torch.where(res.found, out["flow"],
                            normalized_grid(ht, wt, h_used.device)[None]),
        "match": out["match"] * foundf,
        # the raw stride-8 residual: zeros are its no-op
        "flow_down8": out["flow_down8"] * foundf,
        "match_down8": out["match_down8"] * foundf,
    }


@torch.inference_mode()
def fused_align(resnet, align, pyramid, target, generator=None, tolerance=0.05,
                n_iter=10000, kernel_size=7, cycle_match=True,
                injected_samples=None, adaptive_chunk=0, anchor_stride=0,
                relax_cells=0):
    """Align one pair on the device of its tensors.

    resnet: `ResNet50Layer3`; align: the alignment networks
      (`pipeline.init_alignment_params`), all on that device, in eval mode.
    pyramid: tuple of (1, Hi, Wi, 3) source scales (the middle one is warped
      by the fine stage); target: (1, Ht, Wt, 3).
    generator: `torch.Generator` on that device for the RANSAC draws.
    injected_samples: optional RANSAC minimal sets (match indices) used
      instead of drawing: (n_iter, 4), or for adaptive RANSAC all its blocks'
      (ceil(n_iter / adaptive_chunk) * adaptive_chunk, 4).
    adaptive_chunk > 0: adaptive RANSAC in blocks of this size, n_iter the
      cap. anchor_stride, relax_cells: see `_coarse_match`.

    Returns dict: 'H21' (3, 3), 'found' (), 'num_inliers' (), 'flow'
    (1, Ht, Wt, 2), 'match' (Ht, Wt), 'flow_down8', 'match_down8'.
    """
    m1, m2, valid = _coarse_match(resnet, pyramid, target, anchor_stride, relax_cells)
    if adaptive_chunk:
        res, _ = ransac_homography_adaptive(m1, m2, valid, tolerance, n_iter=n_iter,
                                            chunk=adaptive_chunk, generator=generator,
                                            injected_samples=injected_samples)
    else:
        res = ransac_homography(m1, m2, valid, tolerance, n_iter=n_iter,
                                generator=generator, injected_samples=injected_samples)
    return _fine_with_gate(align, pyramid, target, res, cycle_match, kernel_size)


@torch.inference_mode()
def fused_align_batch(resnet, align, pyramids, targets, generator=None,
                      tolerance=0.05, n_iter=10000, kernel_size=7,
                      cycle_match=True, adaptive_chunk=0, anchor_stride=0,
                      relax_cells=0, injected_samples=None):
    """`fused_align` over K pairs, one after another.

    pyramids: tuple of (K, 1, Hi, Wi, 3) stacked scales; targets:
    (K, 1, Ht, Wt, 3). The pairs draw from `generator` in turn, or pair k
    from generator[k] when it is a list of K generators, or takes
    injected_samples[k] ((K, rows, 4): `fused_align`'s per pair). Returns
    the dict of `fused_align` with a leading K axis.
    """
    k_pairs = targets.shape[0]
    gens = generator if isinstance(generator, (list, tuple)) else [generator] * k_pairs
    draws = [None] * k_pairs if injected_samples is None else injected_samples
    outs = [fused_align(resnet, align, tuple(p[k] for p in pyramids), targets[k],
                        gens[k], tolerance, n_iter, kernel_size, cycle_match,
                        injected_samples=draws[k], adaptive_chunk=adaptive_chunk,
                        anchor_stride=anchor_stride, relax_cells=relax_cells)
            for k in range(k_pairs)]
    return {key: torch.stack([o[key] for o in outs]) for key in outs[0]}
