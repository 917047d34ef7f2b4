"""MegaDepth validation: the fine stage's precision under a frozen coarse warp
(port of `ransacflow_tpu/train/validation.py`).

Per CSV row, both images are resized (min side `min_size`, floored to
stride 16) with their correspondence coordinates scaled alike, the source is
warped by a fixed precomputed coarse affine (so that the fine network is
judged alone and epochs compare), one fine pass runs, and the precision is
counted at 8 log-spaced pixel thresholds [1, 2, 3, 5, 8, 13, 22, 36]. Model
selection reads prec@8px (index 4).

The fine pass is `affine_grid` -> kernel 5 (`warp_sample`) -> the feature
extractor twice (kernel 9) -> one `correlation_volume` (kernel 6) ->
`net_flow_coarse` (its flow epilogue kernel 7) -> `flow_to_grid` -> kernel 5
again on the coarse grid. The CSV is read with `eval.table.read_rows`.
"""

import os

import numpy as np
import torch
from PIL import Image

from ransacflow_tpu_torch.kernels.correlation import correlation_volume
from ransacflow_tpu_torch.kernels.warp_sample import warp_sample
from ransacflow_tpu_torch.models.feature_extractor import feature_extractor
from ransacflow_tpu_torch.models.heads import flow_to_grid, net_flow_coarse
from ransacflow_tpu_torch.models.layers import l2_normalize
from ransacflow_tpu_torch.ops.grid import normalized_grid
from ransacflow_tpu_torch.ops.sampler import affine_grid
from ransacflow_tpu_torch.utils.image import min_size_shape_wh

PIXEL_GRID = np.around(np.logspace(0, np.log10(36), 8))  # 1..36 px
FINE_NETS = ("netFeatCoarse", "netFlowCoarse")


def resize_min_resolution(min_size, img, x, y, stride=16):
    """Resize a PIL image's min side to `min_size` (floored to stride),
    scaling the pixel coordinates x, y alike."""
    w, h = img.size
    new_w, new_h = min_size_shape_wh((w, h), min_size, stride)
    img = img.resize((new_w, new_h), resample=Image.LANCZOS)
    return img, x * (new_w / float(w)), y * (new_h / float(h))


def fine_forward(nets, src, tgt, theta, kernel_size=7):
    """One fine pass under a fixed coarse affine: (1, Ht, Wt, 2) the
    target -> source sampling grid. src, tgt: (1, H, W, 3) in [0, 1];
    theta: (1, 2, 3)."""
    ht, wt = tgt.shape[1:3]
    flow_global = affine_grid(theta, ht, wt)
    src_sample = warp_sample(src, flow_global)
    feats = l2_normalize(feature_extractor(nets["netFeatCoarse"], src_sample))
    featt = l2_normalize(feature_extractor(nets["netFeatCoarse"], tgt))
    corr21 = correlation_volume(featt, feats, kernel_size)
    flow = net_flow_coarse(nets["netFlowCoarse"], corr21, up8=True, kernel_size=kernel_size)
    final = flow_to_grid(flow, normalized_grid(ht, wt, tgt.device)[None])
    return warp_sample(flow_global, final)


def _parse_coords(field):
    return np.array([float(v) for v in str(field).split(";")], np.float32)


def alignment_error(flow, xa, ya, xb, yb, ws, hs):
    """Pixel error of the predicted correspondences.

    flow: (Ht, Wt, 2) normalized target -> source grid (numpy); (xa, ya):
    the ground-truth source pixels; (xb, yb): the target pixels; (ws, hs):
    the source size. Both coordinate pairs are truncated by int(), as the
    reference does. Returns the distances (n,).
    """
    xb_i = xb.astype(int)
    yb_i = yb.astype(int)
    sx = (flow[yb_i, xb_i, 0] + 1) * 0.5 * (ws - 1)
    sy = (flow[yb_i, xb_i, 1] + 1) * 0.5 * (hs - 1)
    return np.sqrt((sx - xa.astype(int)) ** 2 + (sy - ya.astype(int)) ** 2)


def _image(scene_dir, name):
    return Image.open(os.path.join(scene_dir, name)).convert("RGB")


@torch.inference_mode()
def validate(rows, val_dir, coarse_transforms, nets, device, kernel_size=7, min_size=480):
    """The validation epoch.

    rows: the CSV's rows (`eval.table.read_rows`), each with scene,
      source_image, target_image and XA, YA, XB, YB (';'-separated pixel
      coordinates).
    coarse_transforms: one (2, 3) affine per row (the reference's
      coarse.pkl).
    nets: the alignment networks on `device`, run in eval mode (their
      modes are restored after).
    Returns the precision (8,) at the PIXEL_GRID thresholds.
    """
    if len(coarse_transforms) < len(rows):
        raise ValueError(f"{len(coarse_transforms)} coarse transforms for {len(rows)} "
                         "rows: the coarse.pkl holds one (2, 3) affine per CSV row")
    modes = {name: nets[name].training for name in FINE_NETS}
    for name in FINE_NETS:
        nets[name].eval()
    hits = np.zeros(8)
    total = 0
    try:
        for row, theta in zip(rows, coarse_transforms):
            scene_dir = os.path.join(val_dir, str(row["scene"]))
            i_s, xa, ya = resize_min_resolution(
                min_size, _image(scene_dir, row["source_image"]),
                _parse_coords(row["XA"]), _parse_coords(row["YA"]))
            i_t, xb, yb = resize_min_resolution(
                min_size, _image(scene_dir, row["target_image"]),
                _parse_coords(row["XB"]), _parse_coords(row["YB"]))
            ws, hs = i_s.size
            src = torch.from_numpy(np.asarray(i_s, np.float32) / 255.0)[None].to(device)
            tgt = torch.from_numpy(np.asarray(i_t, np.float32) / 255.0)[None].to(device)
            theta = torch.from_numpy(np.asarray(theta, np.float32))[None].to(device)
            flow = fine_forward(nets, src, tgt, theta, kernel_size)[0].cpu().numpy()
            err = alignment_error(flow, xa, ya, xb, yb, ws, hs)
            hits += (err.reshape(-1, 1) < PIXEL_GRID.reshape(1, -1)).sum(axis=0)
            total += len(err)
    finally:
        for name, training in modes.items():
            nets[name].train(training)
    return hits / max(total, 1)
