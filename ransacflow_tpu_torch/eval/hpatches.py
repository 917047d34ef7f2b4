"""HPatches dense-alignment harness, DGC-Net AEPE at 240x240 (port of
`ransacflow_tpu/eval/hpatches.py`).

Prediction mirrors evaluation/evalHpatch/evaluation.py:145-260 (min side
480, 7 scales, 50k RANSAC hypotheses, match12-only acceptance); the metric
pass mirrors getResults.py:16-63,83-156,196-253 (flows composed on a 240x240
grid by kernel 8, the ground-truth grid from the scaled CSV homography, AEPE
over the pixels whose ground truth lands in bounds).
"""

import os

import numpy as np
import torch
from PIL import Image

from ransacflow_tpu_torch.device import as_device
from ransacflow_tpu_torch.eval.artifacts import load_pair, save_pair
from ransacflow_tpu_torch.eval.compose import merge_multi_h, put, reconstruct_flows
from ransacflow_tpu_torch.eval.pooled import pool_devices, pooled_multihomo_predict
from ransacflow_tpu_torch.eval.table import read_hpatches
from ransacflow_tpu_torch.ops.grid import normalized_grid
from ransacflow_tpu_torch.ops.homography import warp_grid
from ransacflow_tpu_torch.pipeline.coarse import CoarseAligner
from ransacflow_tpu_torch.pipeline.multihomo import multi_homography_predict
from ransacflow_tpu_torch.utils.image import resized_shape_min_size

SCENES = (2, 3, 4, 5, 6)


def _paths(image_dir, row):
    """(source, target) image paths of an HPatches row."""
    obj_dir = os.path.join(image_dir, row["obj"])
    return (os.path.join(obj_dir, f"{row['im1']}.ppm"),
            os.path.join(obj_dir, f"{row['im2']}.ppm"))


def predict_hpatches(
    csv_dir,
    image_dir,
    out_dir,
    resnet,
    align_params,
    device,
    scenes=SCENES,
    min_size=480,
    nb_scale=7,
    n_iter=50000,
    tolerance=0.05,
    scale_r=2.0,
    max_coarse=10,
    mask_region_th=0.01,
    bg_mask_fn=None,
    begin_index=0,
    end_index=None,
    n_devices=None,
    batch_pairs=None,
    adaptive_chunk=0,
    anchor_stride=0,
    relax_cells=0,
):
    """Run prediction for HPatches scenes 1-2..1-6 on `device`.

    Args:
      resnet, align_params: the coarse trunk and the alignment networks on
        `device`.
      bg_mask_fn: optional callable(img_path, (Ht, Wt)) -> foreground mask
        (the segNet sky-removal hook).
      n_devices: None runs the host loop (`multi_homography_predict`, with
        the fp64 polish of each winner); otherwise a pool of slots
        (`eval.pooled.pool_devices`: a count of `device`'s type, or a list
        of devices) runs each pair through the device-resident loop on
        draws that depend on the pair index alone, batch_pairs > 1 in
        batches of same-resized-shape pairs (`eval.pooled`). The artifacts
        are the same for any pool and batching.
    """
    coarse_kwargs = dict(
        nb_scale=nb_scale, n_iter=n_iter, tolerance=tolerance, min_size=min_size,
        scale_r=scale_r, resize_mode="min", adaptive_chunk=adaptive_chunk,
        anchor_stride=anchor_stride, relax_cells=relax_cells,
    )
    loop_kw = dict(max_coarse=max_coarse, mask_region_th=mask_region_th, cycle_match=False)
    if n_devices is None:
        coarse = CoarseAligner(resnet, device, **coarse_kwargs)
    for scene in scenes:
        rows = read_hpatches(os.path.join(csv_dir, f"hpatches_1_{scene}.csv"))
        scene_out = os.path.join(out_dir, str(scene))
        end = len(rows) if end_index is None else min(end_index, len(rows))
        if n_devices is not None:
            pooled_multihomo_predict(
                _pooled_pairs(image_dir, rows, range(begin_index, end), min_size,
                              bg_mask_fn),
                resnet, align_params, pool_devices(n_devices, device), coarse_kwargs,
                save_fn=lambda idx, art: save_pair(scene_out, idx, art),
                batch_pairs=batch_pairs, **loop_kw)
            continue
        for idx in range(begin_index, end):
            src_path, tgt_path = _paths(image_dir, rows[idx])
            coarse.set_pair(Image.open(src_path).convert("RGB"),
                            Image.open(tgt_path).convert("RGB"))
            bg = None
            if bg_mask_fn is not None:
                bg = bg_mask_fn(tgt_path, coarse.tgt_array.shape[:2])
            pred = multi_homography_predict(coarse, align_params, bg_mask=bg, **loop_kw)
            if pred is not None:
                save_pair(scene_out, idx, pred)


def _pooled_pairs(image_dir, rows, indices, min_size, bg_mask_fn):
    """(idx, source, target, bg_mask or None) of the rows at `indices` for
    `pooled_multihomo_predict`; the mask is made at the target's resized
    shape, which the PIL size gives before the pair is set."""
    for idx in indices:
        src_path, tgt_path = _paths(image_dir, rows[idx])
        i_t = Image.open(tgt_path).convert("RGB")
        bg = None
        if bg_mask_fn is not None:
            bg = bg_mask_fn(tgt_path, resized_shape_min_size(i_t, min_size))
        yield idx, Image.open(src_path).convert("RGB"), i_t, bg


def hpatches_gt_grid(row, out_size, image_dir):
    """DGC-Net ground-truth grid: the CSV homography, rescaled to
    (out_size, out_size), applied inversely to the pixel grid, normalized
    (getResults.py:83-144). `row` is a row of `eval.table.read_hpatches`;
    the target's size is read from its header by PIL."""
    h_ref, w_ref = row["Him"], row["Wim"]
    w_trg, h_trg = Image.open(_paths(image_dir, row)[1]).size
    H = row["H"]

    S1 = np.diag([out_size / w_ref, out_size / h_ref, 1.0])
    S2 = np.diag([out_size / w_trg, out_size / h_trg, 1.0])
    H_scale = S2 @ H @ np.linalg.inv(S1)
    Hinv = np.linalg.inv(H_scale)

    X, Y = np.meshgrid(
        np.linspace(0, out_size - 1, out_size),
        np.linspace(0, out_size - 1, out_size),
    )
    pts = np.stack([X.ravel(), Y.ravel(), np.ones_like(X.ravel())])
    warp = Hinv @ pts
    xw = 2 * warp[0] / (warp[2] + 1e-8) / (out_size - 1) - 1
    yw = 2 * warp[1] / (warp[2] + 1e-8) / (out_size - 1) - 1
    return np.stack(
        [xw.reshape(out_size, out_size), yw.reshape(out_size, out_size)],
        axis=-1,
    ).astype(np.float32)


@torch.inference_mode()
def evaluate_hpatches(
    pred_dir,
    csv_dir,
    image_dir,
    device,
    scenes=SCENES,
    out_size=240,
    multi_h=True,
    th=1.0,
    only_coarse=False,
):
    """AEPE per scene, the flows composed on `device`. Returns
    ({scene: mean_aepe}, {scene: per-pair list})."""
    device = as_device(device)
    grid = normalized_grid(out_size, out_size, "cpu").numpy()
    results = {}
    per_pair = {}
    for scene in scenes:
        rows = read_hpatches(os.path.join(csv_dir, f"hpatches_1_{scene}.csv"))
        scene_dir = os.path.join(pred_dir, str(scene))
        aepes = []
        for idx, row in enumerate(rows):
            art = load_pair(scene_dir, idx)
            if art is None:
                flow_est = grid
            elif only_coarse:
                flow_est = warp_grid(put(art["coarse_h"][:1], device), out_size,
                                     out_size)[0].cpu().numpy()
            else:
                flows, matches = reconstruct_flows(
                    art["coarse_h"], art["fine_flow_down8"], art["fine_match_down8"],
                    out_size, out_size, device, cycle_match=False,
                )
                flow_est = merge_multi_h(flows, matches, th, multi_h)["flow"]

            gt = hpatches_gt_grid(row, out_size, image_dir)
            mask = (
                (gt[..., 0] >= -1) & (gt[..., 0] <= 1)
                & (gt[..., 1] >= -1) & (gt[..., 1] <= 1)
            )
            to_px = (out_size - 1) / 2.0
            diff = (flow_est - gt) * to_px
            epe = np.sqrt((diff[..., 0] ** 2 + diff[..., 1] ** 2))[mask]
            aepes.append(float(epe.mean()))
        results[scene] = float(np.mean(aepes))
        per_pair[scene] = aepes
    return results, per_pair
