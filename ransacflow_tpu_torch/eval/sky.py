"""Sky-mask hooks for the eval harnesses (a copy of
`ransacflow_tpu/eval/sky.py`: importing the JAX package imports JAX).

The reference computes It_bg = (imresize(skyFromSeg(path), (Ith, Itw)) <
128): the {0, 1} sky mask resized to the working resolution and inverted,
so 1 = usable foreground (e.g. evaluation/evalHpatch/evaluation.py:177-182).
"""

import numpy as np
from PIL import Image


def resize_mask(mask, hw):
    """Bilinear-resize a float {0, 1} mask to (H, W) and threshold < 0.5,
    mirroring scipy imresize(mask) * 255 < 128."""
    h, w = hw
    img = Image.fromarray((mask * 255).astype(np.uint8))
    resized = np.asarray(img.resize((w, h), resample=Image.BILINEAR))
    return (resized < 128).astype(np.float32)


def make_sky_bg_fn(segmenter):
    """bg_mask_fn(img_path, (Ht, Wt)) for HPatches/KITTI-style harnesses."""

    def fn(img_path, hw):
        return resize_mask(segmenter.get_sky(img_path), hw)

    return fn


def make_sky_bg_fn_rotated(segmenter):
    """bg_mask_fn(img_path, (Ht, Wt), angle) for the YFCC harness: the sky
    mask is computed on the unrotated image and rotated with the target
    (evaluation/evalYFCC/evaluation.py:190-212)."""

    def fn(img_path, hw, angle):
        sky = np.rot90(segmenter.get_sky(img_path), angle // 90)
        return resize_mask(sky, hw)

    return fn
