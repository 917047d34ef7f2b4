"""Pyramid scales and shapes (host helpers, copied from
`ransacflow_tpu/utils/image.py:73` and `bench.py:45-58`)."""

import numpy as np


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
