"""The serving path: one pair aligned on the device with no host round trip
(port of `ransacflow_tpu/pipeline/fused.py`).

Multi-scale coarse features -> mutual matching -> RANSAC -> homography warp
-> fine stage. `fused_align_batch` runs K pairs in chunks, each chunk's
coarse step, fit and fine stage one batched call each; the reference's batch
modes name the chunk size: 'scan' one pair, 'vmap' all K, 'chunkv<k>' k
pairs, and 'hybrid', 'chunk<k>' and 'chunkf<k>' are the reference's names
for 'vmap' and 'chunkv<k>' (the reference's own paths for them give the
same outputs, with fewer of the stages batched). `fused_align` is
`fused_align_batch` of one pair. The pyramid is kernel 1
(`kernels/pyramid.device_pyramid`, re-exported here). The opt-in fast
modes: `anchor_stride` (the trunk at every k-th scale only, the other
scales' bank rows resampled from the nearest anchor by kernel 12),
`relax_cells` (relaxed reciprocity in kernel 2) and `adaptive_chunk`
(adaptive RANSAC, kernel 4). Their defaults are the reference's exact
mode.
"""

import torch

from ransacflow_tpu_torch.kernels.pyramid import device_pyramid  # noqa: F401  (K1)
from ransacflow_tpu_torch.ops.grid import feature_cell_coords, normalized_grid
from ransacflow_tpu_torch.ops.matching import mutual_matching
from ransacflow_tpu_torch.ops.ransac import ransac_homography, ransac_homography_adaptive
from ransacflow_tpu_torch.pipeline.bank import anchor_bank, bank_coords, coarse_features
from ransacflow_tpu_torch.pipeline.fine import fine_features, pred_flow_mask_homography
from ransacflow_tpu_torch.utils.monitor import span


def _coarse_match_batch(resnet, pyramid, target, anchor_stride=0, relax_cells=0):
    """Coarse features and mutual matching for k pairs: pyramid a tuple of
    (k, Hi, Wi, 3) scales, target (k, Ht, Wt, 3). The trunk runs once per
    scale for the k pairs, the scores are one `torch.bmm` and their
    epilogue one launch of kernel 2.

    anchor_stride > 0: the anchor-pyramid banks (one launch of kernel 12,
    `pipeline.bank.anchor_bank`); relax_cells > 0: relaxed
    reciprocity over the target grid.

    Returns (m1, m2, valid): homogeneous (k, nB, 3) match arrays keyed by
    target cell, invalid rows masked by valid (k, nB).
    """
    device = target.device
    with span("rf.align.features"):
        if anchor_stride:
            bank = anchor_bank(resnet, pyramid, anchor_stride)
        else:
            bank = torch.cat([coarse_features(resnet, img).flatten(1, 2) for img in pyramid],
                             dim=1)
        coords_a = bank_coords([img.shape[1:3] for img in pyramid], device)
        ft = coarse_features(resnet, target)
        y, x = feature_cell_coords(ft.shape[1], ft.shape[2], device)
        coords_b = torch.stack([x, y], dim=1).expand(ft.shape[0], -1, -1)
    with span("rf.align.matching"):
        m = mutual_matching(bank.transpose(1, 2), ft.flatten(1, 2).transpose(1, 2),
                            relax_cells=relax_cells, grid_w=ft.shape[2])
        ones = torch.ones(coords_b.shape[:2] + (1,), dtype=coords_b.dtype, device=device)
        m1 = torch.cat([coords_a[m.src_idx.long()], ones], dim=2)
        m2 = torch.cat([coords_b, ones], dim=2)
    return m1, m2, m.valid


def _ransac_batch(m1, m2, valid, gens, tolerance, n_iter, adaptive_chunk, draws):
    """k pairs' fits in one launch: fixed-count (kernel 3), or adaptive in
    blocks of adaptive_chunk with n_iter the cap (kernel 4); pair p under
    gens[p] or draws[p]."""
    injected = None if draws[0] is None else torch.stack(list(draws))
    if adaptive_chunk:
        res, _ = ransac_homography_adaptive(m1, m2, valid, tolerance, n_iter=n_iter,
                                            chunk=adaptive_chunk, generator=list(gens),
                                            injected_samples=injected)
        return res
    return ransac_homography(m1, m2, valid, tolerance, n_iter=n_iter, generator=list(gens),
                             injected_samples=injected)


def _fine_with_gate_batch(align, pyramid, target, h21, found, num_inliers, cycle_match,
                          kernel_size):
    """The fine stage of k pairs at once, each gated on its RANSAC failure:
    identity replaces a failed H21 before the warp, its matchability is
    zeroed, and its flows become no-ops. pyramid: (k, Hi, Wi, 3) scales;
    target (k, Ht, Wt, 3); h21 (k, 3, 3), found (k,), num_inliers (k,).
    Returns `fused_align_batch`'s dict for these k pairs."""
    with span("rf.align.fine"):
        ht, wt = target.shape[1:3]
        eye = torch.eye(3, dtype=h21.dtype, device=h21.device)
        h_used = torch.where(found[:, None, None], h21, eye)
        src = pyramid[len(pyramid) // 2]
        out = pred_flow_mask_homography(align, src, fine_features(align, target), h_used,
                                        (ht, wt), cycle_match=cycle_match,
                                        kernel_size=kernel_size)

        def gated(x):  # zeroed where RANSAC failed, in x's own dtype
            return x * found.to(x.dtype).view((-1,) + (1,) * (x.dim() - 1))

        return {
            "H21": h_used,
            "found": found,
            "num_inliers": num_inliers,
            # an absolute sampling grid: the identity grid is its no-op
            "flow": torch.where(found[:, None, None, None], out["flow"],
                                normalized_grid(ht, wt, h_used.device))[:, None],
            "match": gated(out["match"]),
            # the raw stride-8 residual: zeros are its no-op
            "flow_down8": gated(out["flow_down8"])[:, None],
            "match_down8": gated(out["match_down8"])[:, None],
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
      cap. anchor_stride, relax_cells: see `_coarse_match_batch`.

    Returns dict: 'H21' (3, 3), 'found' (), 'num_inliers' (), 'flow'
    (1, Ht, Wt, 2), 'match' (Ht, Wt), 'flow_down8', 'match_down8': those of
    `fused_align_batch` of this one pair.
    """
    out = fused_align_batch(
        resnet, align, tuple(p[None] for p in pyramid), target[None], [generator],
        tolerance=tolerance, n_iter=n_iter, kernel_size=kernel_size, cycle_match=cycle_match,
        adaptive_chunk=adaptive_chunk, anchor_stride=anchor_stride, relax_cells=relax_cells,
        injected_samples=None if injected_samples is None else injected_samples[None])
    return {key: v[0] for key, v in out.items()}


def parse_batch_mode(batch_mode, n_pairs):
    """The chunk size of a batch mode for K = n_pairs pairs: 'scan' 1,
    'vmap' and 'hybrid' K, 'chunk<k>', 'chunkf<k>' and 'chunkv<k>' k.
    Raises ValueError on an unknown mode and when K is not divisible by the
    chunk size, as the reference does."""
    if batch_mode == "scan":
        return 1
    if batch_mode in ("vmap", "hybrid"):
        return n_pairs
    if batch_mode.startswith("chunk"):
        spec = batch_mode[5:]
        digits = spec[1:] if spec[:1] in ("v", "f") else spec
        if digits.isdigit() and int(digits) > 0:
            c = int(digits)
            if n_pairs % c:
                raise ValueError(f"batch_mode {batch_mode!r} needs the pair count ({n_pairs}) "
                                 f"divisible by the chunk size ({c})")
            return c
    raise ValueError(f"unknown batch_mode: {batch_mode!r}")


@torch.inference_mode()
def fused_align_batch(resnet, align, pyramids, targets, generator=None,
                      tolerance=0.05, n_iter=10000, kernel_size=7,
                      cycle_match=True, adaptive_chunk=0, anchor_stride=0,
                      relax_cells=0, injected_samples=None, batch_mode="scan"):
    """`fused_align` over K pairs in one of the reference's batch modes.

    pyramids: tuple of (K, 1, Hi, Wi, 3) stacked scales; targets:
    (K, 1, Ht, Wt, 3). The pairs draw from `generator` in pair order, one
    seed a pair, or pair k from generator[k] when it is a list of K
    generators, or takes injected_samples[k] ((K, rows, 4): `fused_align`'s
    per pair); the trunk and the fine stage draw nothing, so every mode
    gives each pair the draws it has under 'scan'.
    batch_mode: the chunk size (`parse_batch_mode`). Each chunk runs the
      coarse features and matching (`_coarse_match_batch`), RANSAC (one
      launch of kernel 3 or 4, `_ransac_batch`) and the fine stage
      (`_fine_with_gate_batch`) once for its pairs: 'scan' runs the pairs
      one after another, 'vmap' and 'hybrid' all K at once, 'chunk<k>',
      'chunkf<k>' and 'chunkv<k>' k at a time. Every mode returns what
      'scan' returns, pair by pair.
    Returns the dict of `fused_align` with a leading K axis.
    """
    k_pairs = targets.shape[0]
    chunk = parse_batch_mode(batch_mode, k_pairs)
    gens = generator if isinstance(generator, (list, tuple)) else [generator] * k_pairs
    draws = [None] * k_pairs if injected_samples is None else injected_samples
    outs = []
    with span("rf.align"):
        for c0 in range(0, k_pairs, chunk):
            pairs = slice(c0, c0 + chunk)
            pyr = tuple(p[pairs, 0] for p in pyramids)
            tgt = targets[pairs, 0]
            m1, m2, valid = _coarse_match_batch(resnet, pyr, tgt, anchor_stride, relax_cells)
            with span("rf.align.fit"):
                res = _ransac_batch(m1, m2, valid, gens[pairs], tolerance, n_iter,
                                    adaptive_chunk, draws[pairs])
            outs.append(_fine_with_gate_batch(align, pyr, tgt, res.H21, res.found,
                                              res.num_inliers, cycle_match, kernel_size))
        return {key: torch.cat([o[key] for o in outs]) for key in outs[0]}
