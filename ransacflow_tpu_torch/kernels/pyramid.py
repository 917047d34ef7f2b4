"""Kernel 1: the Lanczos-3 scale pyramid (`csrc/pyramid.cu`)."""

import ctypes
import math

import numpy as np
import torch

from ransacflow_tpu_torch.kernels.build import Kernel, check, forbid_grad, ptr, stream

LANCZOS_RADIUS = 3.0
TILE_H, TILE_W = 16, 32  # kTileH, kTileW in the source
KERNEL = Kernel("rf_lanczos_pyramid",
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
_plans = {}  # (H, W, shapes, device) -> launch plan


def _lanczos3(x):
    """The Lanczos-3 kernel of `jax.image.resize` at distances x >= 0."""
    y = LANCZOS_RADIUS * torch.sin(math.pi * x) * torch.sin(math.pi * x / LANCZOS_RADIUS)
    w = torch.where(x > 1e-3, y / torch.where(x != 0, math.pi ** 2 * x ** 2, 1.0), 1.0)
    return torch.where(x > LANCZOS_RADIUS, 0.0, w)


def resize_weights(in_size, out_size, device, kernel):
    """(in_size, out_size) weights of `jax.image.resize` along one axis with
    `kernel` (a function of the distance), built as JAX builds them
    (`compute_weight_mat`: half-pixel centres, the kernel widened by 1/scale
    on downscale, columns normalized, samples outside the input zeroed), in
    fp32 with JAX's fp32 rounding of the inverse scale."""
    f32 = torch.float32
    inv = 1.0 / (out_size / in_size)  # a Python double, as in JAX
    inv_scale = torch.full((), inv, dtype=f32, device=device)
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32, device=device)[:, None]
         ).abs() / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _lanczos3_weights(in_size, out_size, device):
    """`resize_weights` of `jax.image.resize(..., 'lanczos3')`."""
    return resize_weights(in_size, out_size, device, _lanczos3)


def device_pyramid_ref(image, shapes):
    """Plain PyTorch: each (h, w) of `shapes` other than the input's own is
    an antialiased Lanczos-3 resize of (B, H, W, 3) `image` with
    `jax.image.resize`'s numbers, the per-axis weight matrices applied as
    matrix products (rows first). Returns a tuple of (B, h, w, 3)."""
    _, H, W, _ = image.shape
    out = []
    for h, w in shapes:
        x = image
        if h != H:
            x = torch.einsum("bhwc,hH->bHwc", x, _lanczos3_weights(H, h, x.device))
        if w != W:
            x = torch.einsum("bhwc,wW->bhWc", x, _lanczos3_weights(W, w, x.device))
        out.append(x.contiguous())
    return tuple(out)


def taps(in_size, out_size, weights=_lanczos3_weights):
    """Per-output (start, count, weights (out_size, T)) of one axis: the
    nonzero span of each column of the `weights(in_size, out_size, "cpu")`
    matrix (count 0 for an output outside the input; the identity for
    out_size == in_size)."""
    if in_size == out_size:
        return (np.arange(out_size, dtype=np.int32), np.ones(out_size, np.int32),
                np.ones((out_size, 1), np.float32))
    w = weights(in_size, out_size, "cpu").numpy().T  # (out, in)
    nz = w != 0
    any_nz = nz.any(axis=1)
    start = np.where(any_nz, nz.argmax(axis=1), 0).astype(np.int32)
    stop = np.where(any_nz, in_size - nz[:, ::-1].argmax(axis=1), 0)
    count = (stop - start).astype(np.int32)
    taps = np.zeros((out_size, max(int(count.max()), 1)), np.float32)
    for o in range(out_size):
        taps[o, :count[o]] = w[o, start[o]:stop[o]]
    return start, count, taps


def _plan(H, W, shapes, device):
    """The launch plan of a pyramid, built once per input size, scales and
    device and kept: taps and per-scale metadata on the device."""
    key = (H, W, tuple(shapes), device)
    if key in _plans:
        return _plans[key]
    starts, counts, weights, meta = [], [], [], []
    n_idx = n_w = n_out = n_tiles = 0
    widest = 1
    for h, w in shapes:
        row = [n_idx, n_w]
        rs, rc, rw = taps(H, h)
        col = [n_idx + h, n_w + rw.size]
        cs, cc, cw = taps(W, w)
        starts += [rs, cs]
        counts += [rc, cc]
        weights += [rw.ravel(), cw.ravel()]
        tiles_x = -(-w // TILE_W)
        meta.append([h, w, *row, rw.shape[1], *col, cw.shape[1], n_out, n_tiles, tiles_x])
        for x0 in range(0, w, TILE_W):  # widest column span a tile reads
            sl = slice(x0, x0 + TILE_W)
            live = cc[sl] > 0
            if live.any():
                widest = max(widest, int((cs[sl] + cc[sl])[live].max() - cs[sl][live].min()))
        n_idx += h + w
        n_w += rw.size + cw.size
        n_out += h * w * 3  # per image; times B at launch
        n_tiles += tiles_x * -(-h // TILE_H)
    def on_device(parts):
        return torch.from_numpy(np.concatenate(parts)).to(device)

    plan = {"meta": torch.tensor(meta, dtype=torch.int64, device=device),
            "starts": on_device(starts), "counts": on_device(counts),
            "weights": on_device(weights), "n_tiles": n_tiles, "n_out": n_out,
            "smem": TILE_H * widest * 3 * 4}
    _plans[key] = plan
    return plan


def device_pyramid(image, shapes):
    """`device_pyramid_ref` for a CPU tensor; for a CUDA one, the kernel
    writes every non-identity scale in one launch (an identity scale is the
    input itself). Forward only."""
    forbid_grad("device_pyramid", image)
    if image.device.type == "cpu":
        return device_pyramid_ref(image, shapes)
    check(image, "image", torch.float32, ndim=4)
    B, H, W, C = image.shape
    if C != 3:
        raise ValueError(f"image: {C} channels, expected 3")
    todo = [(h, w) for h, w in shapes if (h, w) != (H, W)]
    done = {}
    if todo:
        plan = _plan(H, W, todo, image.device)
        # the scales back to back, each (B, h, w, 3)
        out = torch.empty(B * plan["n_out"], dtype=torch.float32, device=image.device)
        if out.numel() >= 2**31 or image.numel() >= 2**31:
            raise ValueError("device_pyramid: tensors must hold fewer than 2^31 elements")
        KERNEL(image.device, ptr(image), ptr(out), ptr(plan["meta"]),
               ptr(plan["starts"]), ptr(plan["counts"]), ptr(plan["weights"]),
               len(todo), plan["n_tiles"], B, H, W, plan["smem"], stream(image))
        offset = 0
        for h, w in todo:
            done[(h, w)] = out[offset:offset + B * h * w * 3].view(B, h, w, 3)
            offset += B * h * w * 3
    return tuple(image if (h, w) == (H, W) else done[(h, w)] for h, w in shapes)
