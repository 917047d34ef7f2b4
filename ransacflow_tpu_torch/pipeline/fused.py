"""The serving path: one pair aligned on the device with no host round trip
(port of `ransacflow_tpu/pipeline/fused.py`).

Multi-scale coarse features -> mutual matching -> RANSAC -> homography warp
-> fine stage. `fused_align_batch` runs K pairs in one of the reference's
batch modes: 'scan' (pair after pair), 'vmap' and 'hybrid' (the stages
batched across all K pairs, RANSAC pair by pair in 'hybrid'), and
'chunk<k>', 'chunkf<k>', 'chunkv<k>' (batched in chunks of k pairs). The
pyramid is kernel 1 (`kernels/pyramid.device_pyramid`, re-exported here).
The opt-in fast modes: `anchor_stride` (the trunk at every k-th scale
only, the other scales' bank rows resampled from the nearest anchor by
kernel 12), `relax_cells` (relaxed reciprocity in kernel 2) and
`adaptive_chunk` (adaptive RANSAC, kernel 4). Their defaults are the
reference's exact mode.
"""

import torch

from ransacflow_tpu_torch.kernels.pyramid import device_pyramid  # noqa: F401  (K1)
from ransacflow_tpu_torch.kernels.ransac import stack_fits
from ransacflow_tpu_torch.ops.grid import feature_cell_coords, normalized_grid
from ransacflow_tpu_torch.ops.matching import mutual_matching
from ransacflow_tpu_torch.ops.ransac import (
    ransac_homography,
    ransac_homography_adaptive,
    ransac_homography_adaptive_batch,
    ransac_homography_batch,
)
from ransacflow_tpu_torch.pipeline.bank import anchor_bank_batch, bank_coords, coarse_features
from ransacflow_tpu_torch.pipeline.fine import fine_features, pred_flow_mask_homography
from ransacflow_tpu_torch.utils.monitor import span


def _coarse_match_batch(resnet, pyramid, target, anchor_stride=0, relax_cells=0):
    """Coarse features and mutual matching for k pairs: pyramid a tuple of
    (k, Hi, Wi, 3) scales, target (k, Ht, Wt, 3). The trunk runs once per
    scale for the k pairs, the scores are one `torch.bmm` and their
    epilogue one launch of kernel 2.

    anchor_stride > 0: the anchor-pyramid banks (one launch of kernel 12,
    `pipeline.bank.anchor_bank_batch`); relax_cells > 0: relaxed
    reciprocity over the target grid.

    Returns (m1, m2, valid): homogeneous (k, nB, 3) match arrays keyed by
    target cell, invalid rows masked by valid (k, nB).
    """
    device = target.device
    with span("rf.align.features"):
        if anchor_stride:
            bank = anchor_bank_batch(resnet, pyramid, anchor_stride)
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


def _ransac(m1, m2, valid, generator, tolerance, n_iter, adaptive_chunk, injected_samples):
    """One pair's fit: fixed-count (kernel 3), or adaptive in blocks of
    adaptive_chunk with n_iter the cap (kernel 4)."""
    if adaptive_chunk:
        res, _ = ransac_homography_adaptive(m1, m2, valid, tolerance, n_iter=n_iter,
                                            chunk=adaptive_chunk, generator=generator,
                                            injected_samples=injected_samples)
        return res
    return ransac_homography(m1, m2, valid, tolerance, n_iter=n_iter, generator=generator,
                             injected_samples=injected_samples)


def _ransac_pairs(m1, m2, valid, gens, tolerance, n_iter, adaptive_chunk, draws):
    """k pairs' fits one after another (k launches), stacked."""
    return stack_fits([_ransac(m1[p], m2[p], valid[p], gens[p], tolerance, n_iter,
                               adaptive_chunk, draws[p]) for p in range(m1.shape[0])])


def _ransac_batch(m1, m2, valid, gens, tolerance, n_iter, adaptive_chunk, draws):
    """k pairs' fits in one launch of kernel 3's (or kernel 4's) batch form,
    pair p under gens[p] or draws[p]."""
    injected = None if draws[0] is None else torch.stack(list(draws))
    if adaptive_chunk:
        res, _ = ransac_homography_adaptive_batch(m1, m2, valid, tolerance, n_iter=n_iter,
                                                  chunk=adaptive_chunk, generator=list(gens),
                                                  injected_samples=injected)
        return res
    return ransac_homography_batch(m1, m2, valid, tolerance, n_iter=n_iter,
                                   generator=list(gens), injected_samples=injected)


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


def _fine_with_gate(align, pyramid, target, res, cycle_match, kernel_size):
    """`_fine_with_gate_batch` of one pair: pyramid (1, Hi, Wi, 3) scales,
    target (1, Ht, Wt, 3), res one fit's H21, found and num_inliers."""
    out = _fine_with_gate_batch(align, pyramid, target, res.H21[None], res.found[None],
                                res.num_inliers[None], cycle_match, kernel_size)
    return {key: v[0] for key, v in out.items()}


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
    (1, Ht, Wt, 2), 'match' (Ht, Wt), 'flow_down8', 'match_down8'.
    """
    with span("rf.align"):
        m1, m2, valid = _coarse_match_batch(resnet, pyramid, target, anchor_stride,
                                            relax_cells)
        with span("rf.align.fit"):
            res = _ransac(m1[0], m2[0], valid[0], generator, tolerance, n_iter,
                          adaptive_chunk, injected_samples)
        return _fine_with_gate(align, pyramid, target, res, cycle_match, kernel_size)


def parse_batch_mode(batch_mode, n_pairs):
    """(chunk size, RANSAC batched, fine stage batched) of a batch mode for
    K = n_pairs pairs: 'scan' (1, yes, yes: a batch of one pair is that
    pair's single fit and fine pass), 'vmap' (K, yes, yes), 'hybrid' (K,
    no, yes), 'chunk<k>' (k, no, no), 'chunkf<k>' (k, no, yes), 'chunkv<k>'
    (k, yes, yes). Raises ValueError on an unknown mode and when K is not
    divisible by the chunk size, as the reference does."""
    if batch_mode == "scan":
        return 1, True, True
    if batch_mode == "vmap":
        return n_pairs, True, True
    if batch_mode == "hybrid":
        return n_pairs, False, True
    if batch_mode.startswith("chunk"):
        spec = batch_mode[5:]
        full, fine = spec.startswith("v"), spec.startswith("f")
        digits = spec[1:] if (full or fine) else spec
        if digits.isdigit() and int(digits) > 0:
            c = int(digits)
            if n_pairs % c:
                raise ValueError(f"batch_mode {batch_mode!r} needs the pair count ({n_pairs}) "
                                 f"divisible by the chunk size ({c})")
            return c, full, full or fine
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
    batch_mode: 'scan' runs the pairs one after another (chunks of one
      pair); 'vmap' runs the coarse features and matching, RANSAC (kernel
      3's or 4's batch form) and the fine stage each once for all K pairs;
      'hybrid' does so but fits pair by pair; 'chunk<k>' batches the coarse features and
      matching in chunks of k pairs, fits and runs the fine stage pair by
      pair; 'chunkf<k>' also batches the fine stage over the chunk;
      'chunkv<k>' batches the whole chunk. Every mode returns what 'scan'
      returns, pair by pair.
    Returns the dict of `fused_align` with a leading K axis.
    """
    k_pairs = targets.shape[0]
    chunk, ransac_batched, fine_batched = parse_batch_mode(batch_mode, k_pairs)
    gens = generator if isinstance(generator, (list, tuple)) else [generator] * k_pairs
    draws = [None] * k_pairs if injected_samples is None else injected_samples
    fit = _ransac_batch if ransac_batched else _ransac_pairs
    outs = []
    with span("rf.align"):
        for c0 in range(0, k_pairs, chunk):
            pairs = slice(c0, c0 + chunk)
            pyr = tuple(p[pairs, 0] for p in pyramids)
            tgt = targets[pairs, 0]
            m1, m2, valid = _coarse_match_batch(resnet, pyr, tgt, anchor_stride, relax_cells)
            with span("rf.align.fit"):
                res = fit(m1, m2, valid, gens[pairs], tolerance, n_iter, adaptive_chunk,
                          draws[pairs])
            if fine_batched:
                outs.append(_fine_with_gate_batch(align, pyr, tgt, res.H21, res.found,
                                                  res.num_inliers, cycle_match, kernel_size))
                continue
            for p in range(m1.shape[0]):
                outs.append(_fine_with_gate_batch(
                    align, tuple(s[p:p + 1] for s in pyr), tgt[p:p + 1], res.H21[p:p + 1],
                    res.found[p:p + 1], res.num_inliers[p:p + 1], cycle_match, kernel_size))
        return {key: torch.cat([o[key] for o in outs]) for key in outs[0]}
