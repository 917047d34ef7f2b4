"""Multi-homography iteration: repeat coarse + fine on the unmatched region
(port of `ransacflow_tpu/pipeline/multihomo.py`).

The shared skeleton of the reference's eval harnesses
(evaluation/evalHpatch/evaluation.py:193-243): keep fitting homographies on
the not-yet-matched target region, refine each with the fine stage, accept
while the newly matched area exceeds a threshold, and stack (H, fine flow at
stride 8, matchability at stride 8) for later compositing. Two forms: the
host loop `multi_homography_predict` (fp64 polish of each winner) and the
device-resident `_fused_multi_homo` behind `multi_homography_predict_fused`.
"""

import numpy as np
import torch

from ransacflow_tpu_torch.ops.ransac import (
    ransac_homography,
    ransac_homography_adaptive,
)
from ransacflow_tpu_torch.pipeline.coarse import (
    _homogeneous_matches,
    _mask_to_cells,
    _match_masked,
)
from ransacflow_tpu_torch.pipeline.fine import fine_features, pred_flow_mask_homography


@torch.inference_mode()
def multi_homography_predict(coarse, params, max_coarse=10, mask_region_th=0.01,
                             cycle_match=True, bg_mask=None, kernel_size=7):
    """Run the multi-homography loop for the pair already set on `coarse`.

    coarse: a `CoarseAligner` with `set_pair` done; params: the alignment
      networks on its device.
    max_coarse: max number of homographies after the first (reference 10).
    mask_region_th: min fraction of newly matched pixels to accept another
      homography (reference 0.01, KITTI 0.005).
    cycle_match: the fine stage's flag (see `pipeline/fine.py`).
    bg_mask: optional (Ht, Wt) float array, 1 = usable foreground, 0 =
      background / sky to exclude.

    Returns None if no homography was found, else a dict of numpy stacks:
    'coarse_h' (n, 3, 3), 'fine_flow_down8' (n, h8, w8, 2),
    'fine_match_down8' (n, h8, w8, 2), 'bg_mask' (Ht, Wt) bool.
    """
    ht, wt = coarse.tgt_array.shape[:2]
    if bg_mask is None:
        bg_mask = np.ones((ht, wt), np.float32)
    src = coarse.put(coarse.src_array)[None]
    featt = fine_features(params, coarse.put(coarse.tgt_array)[None])

    mask = np.zeros((ht, wt), np.float32)
    hs, flows, matches = [], [], []
    nb_coarse = 0
    while nb_coarse <= max_coarse:
        fg_mask = ((mask + (1.0 - bg_mask)) > 0.5).astype(np.float32)
        H, _ = coarse.get_coarse(fg_mask)
        if H is None:
            break
        out = pred_flow_mask_homography(params, src, featt, coarse.put(H)[None], (ht, wt),
                                        cycle_match=cycle_match, kernel_size=kernel_size)
        match_fine = out["match"][0].float().cpu().numpy()
        if (match_fine * (1.0 - fg_mask)).mean() > mask_region_th or nb_coarse == 0:
            hs.append(H)
            flows.append(out["flow_down8"][0].float().cpu().numpy())
            matches.append(out["match_down8"][0].float().cpu().numpy())
            nb_coarse += 1
            # the reference's `len == 0` guard is dead code (the append comes
            # first), so the accepted region is always re-masked by (1 - fg)
            match_fine = match_fine * (1.0 - fg_mask)
            mask = ((mask + match_fine) >= 1.0).astype(np.float32)
        else:
            break

    if not hs:
        return None
    return {
        "coarse_h": np.stack(hs),
        "fine_flow_down8": np.stack(flows),
        "fine_match_down8": np.stack(matches),
        "bg_mask": bg_mask.astype(bool),
    }


@torch.inference_mode()
def _fused_multi_homo(params, bank, featt_c, coords_a, coords_b, cached_src,
                      cached_valid, src, featt_fine, bg_mask, generator,
                      tolerance, mask_region_th, *, feat_h, feat_w, max_coarse,
                      cycle_match, kernel_size, n_iter, rematch,
                      adaptive_chunk=0, relax_cells=0, n_points=4, transform="homography"):
    """The multi-homography loop with its state on the device.

    The loop state lives on the device of `bg_mask` in fixed shapes: the
    (Ht, Wt) mask, the slot stacks `hs` (n_slots, 3, 3), `flows` and
    `matches` (n_slots, h8, w8, 2) with n_slots = max_coarse + 1, `count`
    and `done`. A slot fits a homography on the unmatched region (identity
    when RANSAC finds none), runs the fine stage and writes its results into
    slot `count` only when it is accepted, all with device selects. The only
    host read per slot is the `done` test before it, which plays the part
    of `lax.while_loop`'s cond (count < n_slots holds while the loop runs:
    each slot either accepts and counts or ends the loop). No fp64 polish:
    use the host loop for the reference's exact numbers.

    generator: the `torch.Generator` (on that device) of the RANSAC draws.
    n_points / transform: 4 and 'homography', or 3 and 'affine' (each slot's
    fit; the fine stage warps by the affine map as a homography).
    adaptive_chunk > 0 fits each homography with adaptive RANSAC in blocks of
    this size, n_iter being the cap; 0 draws exactly n_iter hypotheses.
    relax_cells: relaxed reciprocity of the fresh matching in rematch mode
    (`_match_masked`; the cached matches carry it from `set_target`).

    Returns dict of device tensors: 'mask', 'hs', 'flows', 'matches',
    'count' () int32, 'done' () bool and 'n_evaluated' (n_slots,) int32, the
    hypotheses scored by each slot's fit (0 for slots not run).
    """
    ht, wt = bg_mask.shape
    h8, w8 = featt_fine.shape[1:3]
    n_slots = max_coarse + 1
    dev = bg_mask.device
    f32 = torch.float32
    eye = torch.eye(3, dtype=f32, device=dev)
    mask = torch.zeros((ht, wt), dtype=f32, device=dev)
    hs = torch.zeros((n_slots, 3, 3), dtype=f32, device=dev)
    flows = torch.zeros((n_slots, h8, w8, 2), dtype=f32, device=dev)
    matches = torch.zeros((n_slots, h8, w8, 2), dtype=f32, device=dev)
    n_evaluated = torch.zeros(n_slots, dtype=torch.int32, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for slot in range(n_slots):
        if bool(done):  # the one host read of the slot: the loop's cond
            break
        fg = ((mask + (1.0 - bg_mask)) > 0.5).to(f32)
        mask_cell = _mask_to_cells(fg, feat_h, feat_w)
        src_idx, valid = _match_masked(bank, featt_c, mask_cell, cached_src,
                                       cached_valid, rematch, relax_cells, feat_w)
        m1, m2 = _homogeneous_matches(coords_a, coords_b, src_idx)
        if adaptive_chunk:
            res, n_eval = ransac_homography_adaptive(
                m1, m2, valid, tolerance, n_iter=n_iter, chunk=adaptive_chunk,
                generator=generator, n_points=n_points, transform=transform)
            n_evaluated[slot] = n_eval
        else:
            res = ransac_homography(m1, m2, valid, tolerance, n_iter=n_iter,
                                    generator=generator, n_points=n_points,
                                    transform=transform)
            n_evaluated[slot].fill_(n_iter)
        h_used = torch.where(res.found, res.H21, eye)
        out = pred_flow_mask_homography(params, src, featt_fine, h_used[None], (ht, wt),
                                        cycle_match=cycle_match, kernel_size=kernel_size)
        newly = out["match"][0] * (1.0 - fg)
        accept = res.found & ((newly.mean() > mask_region_th) | (count == 0))
        c = count.long().view(1)
        hs.index_copy_(0, c, torch.where(accept, h_used, hs.index_select(0, c)[0])[None])
        flows.index_copy_(0, c, torch.where(accept, out["flow_down8"],
                                            flows.index_select(0, c)))
        matches.index_copy_(0, c, torch.where(accept, out["match_down8"],
                                              matches.index_select(0, c)))
        mask = torch.where(accept, ((mask + newly) >= 1.0).to(f32), mask)
        count = count + accept.to(torch.int32)
        done = ~accept
    return {"mask": mask, "hs": hs, "flows": flows, "matches": matches,
            "count": count, "done": done, "n_evaluated": n_evaluated}


@torch.inference_mode()
def _fused_multi_homo_batch(params, banks, featts_c, coords_a, coords_b,
                            cached_srcs, cached_valids, srcs, featts_fine,
                            bg_masks, generators, tolerance, mask_region_th,
                            **kw):
    """`_fused_multi_homo` over a stack of same-shape pairs, one after
    another (the reference's scan over pairs). Pair k draws from
    `generators[k]`; coords_a / coords_b are shared. Returns the dict of
    `_fused_multi_homo` stacked along a leading pair axis, without the
    loop-state 'mask'. Keyword arguments are `_fused_multi_homo`'s."""
    outs = []
    for k in range(len(generators)):
        out = _fused_multi_homo(
            params, banks[k], featts_c[k], coords_a, coords_b, cached_srcs[k],
            cached_valids[k], srcs[k], featts_fine[k], bg_masks[k],
            generators[k], tolerance, mask_region_th, **kw)
        out.pop("mask")
        outs.append(out)
    return {key: torch.stack([o[key] for o in outs]) for key in outs[0]}


def multi_homography_dispatch(coarse, params, max_coarse=10, mask_region_th=0.01,
                              cycle_match=True, bg_mask=None, kernel_size=7,
                              generator=None):
    """Run the device-resident loop for the pair set on `coarse`; returns
    (final device dict, bg) for `multi_homography_finalize`. Each slot reads
    one flag back (`_fused_multi_homo`); the results stay on the device.

    generator: the RANSAC draws' `torch.Generator`; None draws from the
    aligner's stream (order-dependent). A generator per pair makes the
    artifacts independent of the order of the pairs.
    """
    ht, wt = coarse.tgt_array.shape[:2]
    bg = (np.ones((ht, wt), np.float32) if bg_mask is None
          else np.asarray(bg_mask, np.float32))
    featt_fine = fine_features(params, coarse.put(coarse.tgt_array)[None])
    final = _fused_multi_homo(
        params, coarse._bank, coarse._featt, coarse._coordsA, coarse._coordsB,
        coarse._cached_src, coarse._cached_valid, coarse.put(coarse.src_array)[None],
        featt_fine, coarse.put(bg), coarse.generator if generator is None else generator,
        coarse.tolerance, mask_region_th, feat_h=coarse.feat_h,
        feat_w=coarse.feat_w, max_coarse=max_coarse, cycle_match=cycle_match,
        kernel_size=kernel_size, n_iter=coarse.n_iter, rematch=coarse.rematch,
        adaptive_chunk=coarse.adaptive_chunk, relax_cells=coarse.relax_cells,
        n_points=coarse.n_points, transform=coarse.transform)
    return final, bg


def multi_homography_finalize(final, bg):
    """Read a dispatched loop back as the host artifact dict (None when no
    homography was accepted)."""
    n = int(final["count"])
    if n == 0:
        return None
    return {
        "coarse_h": final["hs"][:n].cpu().numpy().astype(np.float32),
        "fine_flow_down8": final["flows"][:n].cpu().numpy(),
        "fine_match_down8": final["matches"][:n].cpu().numpy(),
        "bg_mask": bg.astype(bool),
    }


def multi_homography_predict_fused(coarse, params, max_coarse=10,
                                   mask_region_th=0.01, cycle_match=True,
                                   bg_mask=None, kernel_size=7, generator=None):
    """`multi_homography_predict` with the loop on the device: the same
    contract and acceptance rule, one host read per slot instead of
    several. Differences from the host loop: no fp64 polish of the winners
    (the device's fp32 solve is used as is) and other RANSAC draws, so the
    draws, though not the fitted geometry, can differ."""
    final, bg = multi_homography_dispatch(
        coarse, params, max_coarse=max_coarse, mask_region_th=mask_region_th,
        cycle_match=cycle_match, bg_mask=bg_mask, kernel_size=kernel_size,
        generator=generator)
    return multi_homography_finalize(final, bg)
