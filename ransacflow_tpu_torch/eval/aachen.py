"""Aachen Day-Night localization support (port of
`ransacflow_tpu/eval/aachen.py`).

The reference's evalAachan directory is documentation only (a results
table; evaluation/evalAachan/README.md): localization runs through the
external visuallocalization.net benchmark, which consumes 2D-2D
correspondences between query and database images. This module exports
the piece RANSAC-Flow contributes, correspondences from the dense
alignment of a query/database pair.
"""

import os

import numpy as np
from PIL import Image

from ransacflow_tpu_torch.eval.compose import merge_multi_h, reconstruct_flows
from ransacflow_tpu_torch.pipeline.multihomo import multi_homography_predict


def export_correspondences(
    coarse,
    align_params,
    query_path,
    db_path,
    match_th=0.95,
    grid_step=8,
    max_coarse=10,
    mask_region_th=0.01,
):
    """Dense-alignment correspondences for one query/database pair.

    Runs the multi-homography loop (host form) with the query as source and
    the database image as target on the device of `coarse` (a
    `CoarseAligner`), composes its flows there (kernel 8), then samples the
    matched pixels on a regular grid of the target.

    Returns None when no alignment was found, else dict(query_xy, db_xy,
    query_size, db_size): pixel coords in the *resized* frames.
    """
    coarse.set_pair(Image.open(query_path).convert("RGB"),
                    Image.open(db_path).convert("RGB"))
    pred = multi_homography_predict(
        coarse, align_params, max_coarse=max_coarse,
        mask_region_th=mask_region_th, cycle_match=True,
    )
    if pred is None:
        return None
    h8, w8 = pred["fine_flow_down8"].shape[1:3]
    flows, matches = reconstruct_flows(
        pred["coarse_h"], pred["fine_flow_down8"], pred["fine_match_down8"],
        h8 * 8, w8 * 8, coarse.device, cycle_match=True,
    )
    merged = merge_multi_h(flows, matches, match_th, multi_h=True)
    flow, ok = merged["flow"], merged["match_binary"]

    ys, xs = np.mgrid[0 : h8 * 8 : grid_step, 0 : w8 * 8 : grid_step]
    keep = ok[ys, xs]
    xs, ys = xs[keep], ys[keep]
    hq, wq = coarse.src_array.shape[:2]
    qx = (flow[ys, xs, 0] + 1) * 0.5 * (wq - 1)
    qy = (flow[ys, xs, 1] + 1) * 0.5 * (hq - 1)
    return {
        "query_xy": np.stack([qx, qy], axis=1),
        "db_xy": np.stack([xs, ys], axis=1).astype(np.float64),
        "query_size": (wq, hq),
        "db_size": (w8 * 8, h8 * 8),
    }


def write_match_file(out_path, pair_name, corr):
    """Append a pair's correspondences in a simple text format (one 'qx qy
    dx dy' row per match) consumable by localization scripts."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "a") as f:
        f.write(f"# {pair_name} {len(corr['query_xy'])}\n")
        for (qx, qy), (dx, dy) in zip(corr["query_xy"], corr["db_xy"]):
            f.write(f"{qx:.2f} {qy:.2f} {dx:.2f} {dy:.2f}\n")
