"""Host image helpers: PIL resizing to the coarse net's stride, pyramid
scales and shapes (copied from `ransacflow_tpu/utils/image.py:14-88` and
`bench.py:45-58`)."""

import numpy as np
from PIL import Image

STRIDE_NET = 16


def min_size_shape_wh(size_wh, min_size, stride=STRIDE_NET):
    """(new_w, new_h) of a min-side resize, floored to stride: the one shape
    rule of every resize and mask (reference:
    evaluation/evalHpatch/coarseAlignFeatMatch.py:90-100)."""
    w, h = size_wh
    ratio = min(w / float(min_size), h / float(min_size))
    new_w, new_h = int(round(w / ratio)), int(round(h / ratio))
    return new_w // stride * stride, new_h // stride * stride


def resize_min_size(img, min_size, stride=STRIDE_NET):
    """Resize a PIL image so the *smaller* side ~= min_size, floor to stride
    (Lanczos)."""
    return img.resize(min_size_shape_wh(img.size, min_size, stride),
                      resample=Image.LANCZOS)


def resized_shape_min_size(img, min_size, stride=STRIDE_NET):
    """(Ht, Wt) that `resize_min_size` would produce, without resizing."""
    new_w, new_h = min_size_shape_wh(img.size, min_size, stride)
    return new_h, new_w


def resize_max_size(img, min_size, stride=STRIDE_NET):
    """Resize so the *larger* side ~= min_size, floor to stride (reference:
    quick_start/coarseAlignFeatMatch.py:80-90)."""
    w, h = img.size
    ratio = max(w / float(min_size), h / float(min_size))
    new_w, new_h = int(round(w / ratio)), int(round(h / ratio))
    new_w, new_h = new_w // stride * stride, new_h // stride * stride
    return img.resize((new_w, new_h), resample=Image.LANCZOS)


def resize_round_stride(img, min_size, stride=STRIDE_NET):
    """Resize so the smaller side = min_size, each side *rounded* (not
    floored) to the stride (reference: utils/outil.py:6-19 ``resizeImg``;
    KITTI's fineSize resizes)."""
    w, h = img.size
    ratio = min(w / min_size, h / min_size)
    w, h = w / ratio, h / ratio
    return img.resize((round(w / stride) * stride, round(h / stride) * stride),
                      resample=Image.LANCZOS)


def to_array(img):
    """PIL -> float32 (H, W, 3) in [0, 1] (torchvision ToTensor semantics,
    channels-last)."""
    return np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0


def scale_list(nb_scale, scale_r):
    """The coarse pyramid's scale factors: nb_scale == 1 -> [1]; else
    linspace(scale_r, 1, n//2+1) ++ linspace(1, 1/scale_r, n//2+1)[1:]."""
    if nb_scale == 1:
        return [1.0]
    up = np.linspace(scale_r, 1, nb_scale // 2 + 1).tolist()
    down = np.linspace(1, 1 / scale_r, nb_scale // 2 + 1).tolist()[1:]
    return up + down


def pyramid_shapes(min_size=480, aspect=(480, 640), nb_scale=7, scale_r=2.0,
                   stride=16):
    """(h, w) of each pyramid scale: the min side resized to
    int(min_size * s), aspect kept, each side floored to `stride`."""
    h0, w0 = aspect
    shapes = []
    for s in scale_list(nb_scale, scale_r):
        scale = int(min_size * s) / min(h0, w0)
        shapes.append((int(round(h0 * scale)) // stride * stride,
                       int(round(w0 * scale)) // stride * stride))
    return shapes
