"""Kernel 12: the anchor mode's feature resample and L2 normalization
(`csrc/anchor_resample.cu`)."""

import ctypes

import numpy as np
import torch

from ransacflow_tpu_torch.kernels.build import Kernel, check, forbid_grad, ptr, stream
from ransacflow_tpu_torch.kernels.pyramid import taps, resize_weights
from ransacflow_tpu_torch.models.layers import l2_normalize

KERNEL = Kernel("rf_anchor_resample",
                [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
                + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                + [ctypes.c_void_p] * 2)
MAX_CHANNELS = 2048  # kThreads * kPerThread in the source
_taps_on_device = {}  # (in, out, device) -> (start, count, weights, T)


def triangle(x):
    """The bilinear (triangle) kernel of `jax.image.resize` at distances x >= 0."""
    return torch.clamp_min(1.0 - x, 0.0)


def bilinear_weights(in_size, out_size, device):
    """`resize_weights` of `jax.image.resize(..., 'bilinear')`."""
    return resize_weights(in_size, out_size, device, triangle)


def anchor_resample_feats_ref(fmap, fh, fw):
    """Plain PyTorch: (1, h, w, C) pre-normalization map -> (fh * fw, C)
    L2-normalized rows of its `jax.image.resize(..., 'bilinear')` to
    (fh, fw), the per-axis weight matrices applied as matrix products (rows
    first); an axis of unchanged size is left as it is."""
    _, h, w, c = fmap.shape
    x = fmap
    if fh != h:
        x = torch.einsum("bhwc,hH->bHwc", x, bilinear_weights(h, fh, x.device))
    if fw != w:
        x = torch.einsum("bhwc,wW->bhWc", x, bilinear_weights(w, fw, x.device))
    return l2_normalize(x).reshape(fh * fw, c)


def _axis(in_size, out_size, device):
    key = (in_size, out_size, device)
    if key not in _taps_on_device:
        start, count, w = taps(in_size, out_size, bilinear_weights)
        _taps_on_device[key] = (torch.from_numpy(start).to(device),
                                torch.from_numpy(count).to(device),
                                torch.from_numpy(np.ascontiguousarray(w)).to(device),
                                w.shape[1])
    return _taps_on_device[key]


def anchor_resample_feats(fmap, fh, fw, out=None):
    """`anchor_resample_feats_ref` for a CPU tensor; for a CUDA one, the
    kernel (taps built once per size pair and kept on the device). `out`:
    an optional contiguous (fh * fw, C) place to write the rows, such as a
    slice of the caller's bank. Forward only."""
    forbid_grad("anchor_resample_feats", fmap)
    if fmap.device.type == "cpu":
        rows = anchor_resample_feats_ref(fmap, fh, fw)
        return rows if out is None else out.copy_(rows)
    check(fmap, "fmap", torch.float32, ndim=4)
    _, h, w, c = fmap.shape
    if fmap.shape[0] != 1 or c > MAX_CHANNELS:
        raise ValueError(f"fmap: shape {tuple(fmap.shape)}, expected (1, h, w, C <= "
                         f"{MAX_CHANNELS})")
    if fmap.numel() >= 2**31 or fh * fw * c >= 2**31:
        raise ValueError("anchor_resample_feats: tensors must hold fewer than 2^31 elements")
    if out is None:
        out = torch.empty((fh * fw, c), dtype=torch.float32, device=fmap.device)
    check(out, "out", torch.float32, shape=(fh * fw, c), device=fmap.device)
    rs, rc, rw, rt = _axis(h, fh, fmap.device)
    cs, cc, cw, ct = _axis(w, fw, fmap.device)
    KERNEL(fmap.device, ptr(fmap), w, c, fh, fw, ptr(rs), ptr(rc), ptr(rw), rt,
           ptr(cs), ptr(cc), ptr(cw), ct, ptr(out), stream(fmap))
    return out
