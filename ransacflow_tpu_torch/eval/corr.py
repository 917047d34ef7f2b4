"""Sparse-correspondence harness, MegaDepth test-1600 / RobotCar test-6511
(port of `ransacflow_tpu/eval/corr.py`).

Prediction mirrors evaluation/evalCorr/evaluation.py (min side 480, 7
scales, 10k hypotheses, cycle-matched fine stage); metrics mirror
getResults.py:15-38,242-289: precision@{1..36}px (8 log-spaced thresholds)
of the predicted correspondences over the annotated sparse points, the
flows composed by kernel 8, with the MegaDepth variant dropping
out-of-bounds ground-truth points.
"""

import os

import numpy as np
from PIL import Image

from ransacflow_tpu_torch.eval.artifacts import load_pair, save_pair
from ransacflow_tpu_torch.eval.compose import merge_multi_h, reconstruct_flows
from ransacflow_tpu_torch.eval.pooled import pool_devices, pooled_multihomo_predict
from ransacflow_tpu_torch.eval.table import read_rows
from ransacflow_tpu_torch.pipeline.coarse import CoarseAligner
from ransacflow_tpu_torch.pipeline.multihomo import multi_homography_predict
from ransacflow_tpu_torch.utils.image import min_size_shape_wh, resized_shape_min_size

PIXEL_GRID = np.around(np.logspace(0, np.log10(36), 8))


def _resize_with_coords(img, x, y, min_size, stride=16, drop_oob=False):
    """Min-side resize (floored to the stride) scaling the annotated
    coordinates, ';'-separated strings (getResults.py:41-76)."""
    x = np.array([float(v) for v in str(x).split(";")], np.float32)
    y = np.array([float(v) for v in str(y).split(";")], np.float32)
    w, h = img.size
    new_w, new_h = min_size_shape_wh((w, h), min_size, stride)
    img = img.resize((new_w, new_h), resample=Image.LANCZOS)
    x, y = x * (new_w / float(w)), y * (new_h / float(h))
    if drop_oob:
        valid = (x > 0) & (x < new_w) & (y > 0) & (y < new_h)
        return img, x, y, valid
    return img, x, y, np.ones(len(x), bool)


def _pair_paths(test_dir, row):
    """(source, target) image paths of a CSV row; scene '/' is the root."""
    scene = str(row["scene"])
    base = test_dir if scene == "/" else os.path.join(test_dir, scene)
    return (os.path.join(base, row["source_image"]),
            os.path.join(base, row["target_image"]))


def _open_pair(test_dir, row):
    src_path, tgt_path = _pair_paths(test_dir, row)
    return Image.open(src_path).convert("RGB"), Image.open(tgt_path).convert("RGB")


def predict_corr(
    csv_path,
    test_dir,
    out_dir,
    resnet,
    align_params,
    device,
    min_size=480,
    nb_scale=7,
    n_iter=10000,
    tolerance=0.05,
    scale_r=2.0,
    max_coarse=10,
    mask_region_th=0.01,
    begin_index=0,
    end_index=None,
    bg_mask_fn=None,
    n_devices=None,
    batch_pairs=None,
    adaptive_chunk=0,
    anchor_stride=0,
    relax_cells=0,
):
    """Run prediction for every CSV row on `device`.

    bg_mask_fn: optional callable(target image path, (Ht, Wt)) -> foreground
      mask, as in the other harnesses. (The JAX package hands it the CSV
      row, which its sky network cannot read: `ROADMAP.md` queue 3.)
    n_devices: None runs the host loop; otherwise a pool of slots
      (`eval.pooled.pool_devices`) runs each pair through the
      device-resident loop on draws that depend on the pair index alone,
      batch_pairs > 1 in batches of same-resized-shape pairs; the artifacts
      are the same for any pool and batching.
    """
    rows = read_rows(csv_path)
    coarse_kwargs = dict(
        nb_scale=nb_scale, n_iter=n_iter, tolerance=tolerance, min_size=min_size,
        scale_r=scale_r, resize_mode="min", adaptive_chunk=adaptive_chunk,
        anchor_stride=anchor_stride, relax_cells=relax_cells,
    )
    loop_kw = dict(max_coarse=max_coarse, mask_region_th=mask_region_th, cycle_match=True)
    end = len(rows) if end_index is None else min(end_index, len(rows))
    if n_devices is not None:
        pooled_multihomo_predict(
            _pooled_pairs(test_dir, rows, range(begin_index, end), min_size, bg_mask_fn),
            resnet, align_params, pool_devices(n_devices, device), coarse_kwargs,
            save_fn=lambda idx, art: save_pair(out_dir, idx, art),
            batch_pairs=batch_pairs, **loop_kw)
        return
    coarse = CoarseAligner(resnet, device, **coarse_kwargs)
    for idx in range(begin_index, end):
        src_path, tgt_path = _pair_paths(test_dir, rows[idx])
        coarse.set_pair(Image.open(src_path).convert("RGB"),
                        Image.open(tgt_path).convert("RGB"))
        bg = None
        if bg_mask_fn is not None:
            bg = bg_mask_fn(tgt_path, coarse.tgt_array.shape[:2])
        pred = multi_homography_predict(coarse, align_params, bg_mask=bg, **loop_kw)
        if pred is not None:
            save_pair(out_dir, idx, pred)


def _pooled_pairs(test_dir, rows, indices, min_size, bg_mask_fn):
    """(idx, source, target, bg_mask or None) of the rows at `indices` for
    `pooled_multihomo_predict`, the mask at the target's resized shape."""
    for idx in indices:
        _, tgt_path = _pair_paths(test_dir, rows[idx])
        i_s, i_t = _open_pair(test_dir, rows[idx])
        bg = None
        if bg_mask_fn is not None:
            bg = bg_mask_fn(tgt_path, resized_shape_min_size(i_t, min_size))
        yield idx, i_s, i_t, bg


def pair_precision_hits(flow, match_agg, m, xs, ys, xt, yt, ws, hs):
    """One pair's precision accounting: hits per PIXEL_GRID threshold and
    the denominator count (reference getResults.py:15-38 ``alignmentError``
    and the matchability gate of the loop at :272-280).

    Returns (hits (8,), n_points). Indices are clipped into bounds: the
    reference indexes raw and relies on its upstream out-of-bounds drop;
    clipping changes nothing on in-bounds data.
    """
    xb = np.clip(xt.astype(np.int64), 0, flow.shape[1] - 1)
    yb = np.clip(yt.astype(np.int64), 0, flow.shape[0] - 1)
    if m > 0:
        ok = match_agg[yb, xb] >= m
    else:
        ok = np.ones(len(xb), bool)
    sx = (flow[yb, xb, 0] + 1) * 0.5 * (ws - 1)
    sy = (flow[yb, xb, 1] + 1) * 0.5 * (hs - 1)
    err = np.sqrt(
        (sx - xs.astype(np.int64)) ** 2 + (sy - ys.astype(np.int64)) ** 2
    )[ok]
    hits = (err.reshape(-1, 1) <= PIXEL_GRID.reshape(1, -1)).sum(0)
    return hits, int(ok.sum())


def evaluate_corr(
    pred_dir,
    csv_path,
    test_dir,
    device,
    dataset="MegaDepth",
    min_size=480,
    multi_h=True,
    th=0.95,
    matchability_th=(0.0,),
    strict_ref_bug=False,
):
    """Precision@PIXEL_GRID per matchability threshold, the flows composed
    on `device`.

    Returns {mth: (precision (8,), n_points)}.

    strict_ref_bug reproduces the reference's missing-pair accounting bit
    for bit (evaluation/evalCorr/getResults.py:275-278): only th=0's
    denominator grows, and, because the reference writes
    ``precAllAlign[0] = precAllAlign[th] + np.zeros(8)`` with ``th`` the
    loop variable leaked from the previous pair's threshold loop, th=0's
    numerator is overwritten with the last threshold's accumulator. A
    missing pair before any complete pair raises NameError in the
    reference; so it does here. The default (False) adds a missing pair to
    every threshold's denominator (the documented fix, PARITY.md §2.6).
    """
    rows = read_rows(csv_path)
    hits = {m: np.zeros(8) for m in matchability_th}
    total = {m: 0 for m in matchability_th}
    drop_oob = dataset == "MegaDepth"
    if strict_ref_bug and 0.0 not in matchability_th:
        # the reference indexes the literal key 0 -> KeyError there too
        raise KeyError("strict_ref_bug requires 0.0 in matchability_th")
    th_leak = None  # the reference's leaked `th` loop variable

    for idx, row in enumerate(rows):
        i_s, i_t = _open_pair(test_dir, row)
        i_s, xs, ys, vs = _resize_with_coords(
            i_s, row["XA"], row["YA"], min_size, drop_oob=drop_oob
        )
        i_t, xt, yt, vt = _resize_with_coords(
            i_t, row["XB"], row["YB"], min_size, drop_oob=drop_oob
        )
        if drop_oob:
            keep = vs & vt
            xs, ys, xt, yt = xs[keep], ys[keep], xt[keep], yt[keep]
        ws, hs = i_s.size

        art = load_pair(pred_dir, idx)
        if art is None:
            if strict_ref_bug:
                if th_leak is None:
                    raise NameError(
                        "missing pair before any complete pair: the "
                        "reference's `th` is undefined here "
                        "(getResults.py:277)"
                    )
                hits[0.0] = hits[th_leak] + np.zeros(8)
                total[0.0] += len(xs)
            else:
                for m in matchability_th:
                    total[m] += len(xs)
            continue
        h8, w8 = art["fine_flow_down8"].shape[1:3]
        flows, matches = reconstruct_flows(
            art["coarse_h"], art["fine_flow_down8"], art["fine_match_down8"],
            h8 * 8, w8 * 8, device, cycle_match=True,
        )
        merged = merge_multi_h(flows, matches, th, multi_h, aggregate_match=True)
        flow, magg = merged["flow"], merged["match"]

        for m in matchability_th:
            h, n = pair_precision_hits(flow, magg, m, xs, ys, xt, yt, ws, hs)
            hits[m] += h
            total[m] += n
            th_leak = m
    return {m: (hits[m] / max(total[m], 1), total[m]) for m in matchability_th}
