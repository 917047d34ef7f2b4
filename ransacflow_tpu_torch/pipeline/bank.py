"""The source feature bank that the serving path (`pipeline.fused`) and the
coarse aligner (`pipeline.coarse`) both build: trunk features per pyramid
scale, exact or in the anchor mode, and the cell coordinates of its rows.
"""

import math

import torch

from ransacflow_tpu_torch.kernels.anchor_resample import anchor_resample_bank
from ransacflow_tpu_torch.models.layers import l2_normalize
from ransacflow_tpu_torch.models.resnet50 import imagenet_preprocess, resnet50_layer3
from ransacflow_tpu_torch.ops.grid import feature_cell_coords


def bank_coords(pyramid_shapes, device, stride=16):
    """(nA, 2) (x, y) cell coords of a pyramid's feature bank."""
    xs, ys = [], []
    for h, w in pyramid_shapes:
        y, x = feature_cell_coords(h // stride, w // stride, device)
        xs.append(x)
        ys.append(y)
    return torch.stack([torch.cat(xs), torch.cat(ys)], dim=1)


def coarse_feat_map(resnet, img):
    """(k, H/16, W/16, 1024) pre-normalization trunk map of (k, H, W, 3)."""
    return resnet50_layer3(resnet, imagenet_preprocess(img))


def coarse_features(resnet, img):
    """(k, H/16, W/16, 1024) L2-normalized trunk features of (k, H, W, 3)."""
    return l2_normalize(coarse_feat_map(resnet, img))


def nearest_anchors(shapes, anchor_stride):
    """For each (H, W) of `shapes`, the index of its anchor: the anchors are
    every anchor_stride-th scale from index 0, and each scale takes the one
    nearest in log-area (ties to the first, as `min` picks)."""
    anchors = list(range(0, len(shapes), int(anchor_stride)))
    log_area = [0.5 * math.log(float(h * w)) for h, w in shapes]
    return [min(anchors, key=lambda a: abs(log_area[a] - log_area[j]))
            for j in range(len(shapes))]


def _anchor_maps(resnet, images, anchor_stride):
    """The trunk maps of the anchor scales of `images`, each scale's (H, W)
    and the index of its anchor."""
    shapes = [tuple(im.shape[1:3]) for im in images]
    nearest = nearest_anchors(shapes, anchor_stride)
    return ({i: coarse_feat_map(resnet, images[i]) for i in sorted(set(nearest))}, shapes,
            nearest)


def anchor_bank(resnet, images, anchor_stride, stride=16):
    """The anchor mode's (k, nA, 1024) banks of k pairs, `images` (k, H, W,
    3) a scale: the trunk runs once per anchor scale for all k, and each
    scale's L2-normalized rows are its nearest anchor's pre-normalization
    map resampled to the scale's grid (an identity for the anchors
    themselves), every pair's every scale in one launch of kernel 12."""
    return anchor_resample_bank(*_anchor_maps(resnet, images, anchor_stride), stride=stride)
