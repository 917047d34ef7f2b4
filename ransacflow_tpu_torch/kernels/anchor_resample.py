"""Kernel 12: the anchor mode's feature bank, every scale's resample and L2
normalization in one launch (`csrc/anchor_resample.cu`), for the k pairs of
the maps' leading axis (k = 1 for one pair)."""

import ctypes

import numpy as np
import torch

from ransacflow_tpu_torch.kernels.build import (
    Kernel,
    check,
    forbid_grad,
    ptr,
    stream,
    upcast,
)
from ransacflow_tpu_torch.kernels.pyramid import taps, resize_weights
from ransacflow_tpu_torch.models.layers import l2_normalize

KERNEL = Kernel("rf_anchor_resample_bank",
                [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
MAX_CHANNELS = 2048     # 32 lanes x 16 float4s in the source
MAX_SCALES = 16         # kMaxScales: rows of the per-scale table
MAX_SMEM = 227 * 1024   # kMaxSmem: shared memory a block can have on the H100
TILE = 8                # kWarps: cells of a block (a resampled scale's output row tile)
# the per-scale fields of `bank_plan`'s meta, in the order of the source's enum
META = ("in", "h", "w", "fh", "fw", "row_idx", "row_w", "row_t", "col_idx", "col_w",
        "col_t", "cell0", "identity", "tiles_x", "span_idx")
_plans = {}  # (anchor sizes, grids, device) -> plan with its taps on the device


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


def anchor_resample_bank_ref(maps, shapes, nearest, stride=16):
    """Plain PyTorch: the (k, nA, C) banks of `shapes` ((H, W) per scale)
    for the k pairs of maps[i] (k, h, w, C), pair p's scale j rows
    `anchor_resample_feats_ref` of `maps[nearest[j]][p]` (a pre-normalization
    map) at its grid (H // stride, W // stride)."""
    k = maps[nearest[0]].shape[0]
    return torch.stack([torch.cat([anchor_resample_feats_ref(maps[i][p:p + 1], h // stride,
                                                             w // stride)
                                   for (h, w), i in zip(shapes, nearest)])
                        for p in range(k)])


def _spans(cs, cc):
    """(first input column, columns) that each tile of TILE output columns
    reads ((0, 0) when none reads a column)."""
    out = []
    for x0 in range(0, len(cs), TILE):
        live = cc[x0:x0 + TILE] > 0
        if not live.any():
            out.append((0, 0))
            continue
        lo = int(cs[x0:x0 + TILE][live].min())
        out.append((lo, int((cs[x0:x0 + TILE] + cc[x0:x0 + TILE])[live].max()) - lo))
    return out


def _interleave(a, b):
    """a and b merged, each spread evenly over the result (a first)."""
    out, ia, ib = [], 0, 0
    while ia < len(a) or ib < len(b):
        if ib == len(b) or (ia < len(a) and ia * len(b) <= ib * len(a)):
            out.append(a[ia])
            ia += 1
        else:
            out.append(b[ib])
            ib += 1
    return out


def bank_plan(in_sizes, grids):
    """K12's launch plan, as numpy arrays: scale j resamples an (h, w) =
    in_sizes[j] map to its (fh, fw) = grids[j]. An identity scale's block
    takes TILE consecutive rows of the bank; a resampled scale's block takes
    TILE neighbouring cells of one output row (tiles_x a row) and stages the
    row taps of the tile's span of input columns. Returns meta (one row of
    META fields per scale; "in", the input pointer, is 0 here and set per
    call), the packed taps (starts, counts, weights: per resampled scale its
    rows', then its columns'), spans ((first input column, columns) per tile
    of each resampled scale), order (the job of each block, (scale << 24) |
    block of the scale: the resampled blocks, bound by L2, spread evenly
    among the identity ones, bound by HBM), n_cells and max_span (input
    columns a block stages at most)."""
    meta, starts, counts, weights, spans = [], [], [], [], []
    jobs = {True: [], False: []}  # identity -> its blocks' jobs
    n = dict.fromkeys(("idx", "w", "span", "cell0", "max_span"), 0)
    for j, ((h, w), (fh, fw)) in enumerate(zip(in_sizes, grids)):
        m = dict.fromkeys(META, 0)
        m.update(h=h, w=w, fh=fh, fw=fw, cell0=n["cell0"], identity=int((h, w) == (fh, fw)))
        if m["identity"]:
            n_blocks = -(-fh * fw // TILE)
        else:
            rs, rc, rw = taps(h, fh, bilinear_weights)
            cs, cc, cw = taps(w, fw, bilinear_weights)
            tiles = _spans(cs, cc)
            m.update(row_idx=n["idx"], row_w=n["w"], row_t=rw.shape[1], col_idx=n["idx"] + fh,
                     col_w=n["w"] + rw.size, col_t=cw.shape[1], tiles_x=len(tiles),
                     span_idx=n["span"])
            starts += [rs, cs]
            counts += [rc, cc]
            weights += [rw.ravel(), cw.ravel()]
            spans.append(np.array(tiles, np.int32).ravel())
            n["idx"] += fh + fw
            n["w"] += rw.size + cw.size
            n["span"] += 2 * len(tiles)
            n["max_span"] = max(n["max_span"], max(k for _, k in tiles))
            n_blocks = fh * len(tiles)
        jobs[bool(m["identity"])] += [(j << 24) | b for b in range(n_blocks)]
        meta.append([m[f] for f in META])
        n["cell0"] += fh * fw
    cat = lambda parts, dtype: (np.concatenate(parts).astype(dtype) if parts  # noqa: E731
                                else np.zeros(1, dtype))
    return {"meta": np.array(meta, np.int64), "starts": cat(starts, np.int32),
            "counts": cat(counts, np.int32), "weights": cat(weights, np.float32),
            "spans": cat(spans, np.int32),
            "order": np.array(_interleave(jobs[False], jobs[True]), np.int32),
            "n_cells": n["cell0"], "max_span": n["max_span"]}


def _plan(in_sizes, grids, device):
    """`bank_plan` with its taps on the device (the per-scale table stays on
    the host: the launch passes it as a kernel parameter), built once per
    sizes and device and kept."""
    key = (in_sizes, grids, device)
    if key not in _plans:
        plan = bank_plan(in_sizes, grids)
        for name in ("starts", "counts", "weights", "spans", "order"):
            plan[name] = torch.from_numpy(plan[name]).to(device)
        _plans[key] = plan
    return _plans[key]


def anchor_resample_bank(maps, shapes, nearest, out=None, stride=16):
    """`anchor_resample_bank_ref` for CPU maps; for CUDA ones, the kernel
    writes every pair's rows of every scale, identity ones included, in one
    launch, each pair's bank bit for bit its own launch's. maps: indexable
    by the anchor indices of `nearest` (a dict or a list), each a
    contiguous (k, h, w, C) fp32 map of k pairs (k = 1 for one); shapes:
    (H, W) per scale; nearest: the anchor index per scale
    (`pipeline.bank.nearest_anchors`). Returns the (k, nA, C) banks; `out`:
    an optional contiguous place for them. At most MAX_SCALES scales.
    Forward only. bf16 maps (the eval policy's trunk) are upcast and the
    banks rounded to bf16, the reference's dtype."""
    srcs = [maps[i] for i in nearest]
    if not 1 <= len(srcs) <= MAX_SCALES or len(shapes) != len(srcs):
        raise ValueError(f"anchor_resample_bank: {len(shapes)} scales and {len(srcs)} "
                         f"anchors; expected the same number, 1 to {MAX_SCALES}")
    forbid_grad("anchor_resample_bank", *srcs)
    if srcs[0].dtype == torch.bfloat16:
        fp32 = {i: upcast(maps[i])[0] for i in set(nearest)}
        bank = anchor_resample_bank(fp32, shapes, nearest, None, stride).bfloat16()
        return bank if out is None else out.copy_(bank)
    if srcs[0].device.type == "cpu":
        bank = anchor_resample_bank_ref(maps, shapes, nearest, stride)
        return bank if out is None else out.copy_(bank)
    dev, c = srcs[0].device, srcs[0].shape[-1]
    k = srcs[0].shape[0]
    for j, fmap in enumerate(srcs):
        check(fmap, f"maps[{nearest[j]}]", torch.float32, ndim=4, device=dev)
        if fmap.shape[0] != k or fmap.shape[-1] != c or fmap.numel() // k >= 2**31:
            raise ValueError(f"maps[{nearest[j]}]: shape {tuple(fmap.shape)}, expected "
                             f"({k}, h, w, {c}) with fewer than 2^31 elements a pair")
        if ptr(fmap) % 16:
            raise ValueError(f"maps[{nearest[j]}]: must be 16-byte aligned")
    if c % 4 or c > MAX_CHANNELS or k > 65535:
        raise ValueError(f"anchor_resample_bank: C = {c}, expected a multiple of 4 "
                         f"<= {MAX_CHANNELS}; {k} pairs, at most 65535")
    plan = _plan(tuple(tuple(m.shape[1:3]) for m in srcs),
                 tuple((h // stride, w // stride) for h, w in shapes), dev)
    n_cells, smem = plan["n_cells"], plan["max_span"] * c * 4
    if n_cells * c >= 2**31:
        raise ValueError("anchor_resample_bank: the bank must hold fewer than 2^31 elements")
    if smem > MAX_SMEM:
        raise ValueError(f"anchor_resample_bank: a tile stages {plan['max_span']} input "
                         f"columns, {smem} bytes of shared memory > {MAX_SMEM}")
    shape = (k, n_cells, c)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    check(out, "out", torch.float32, shape=shape, device=dev)
    if ptr(out) % 16:
        raise ValueError("out: must be 16-byte aligned")
    meta = plan["meta"].copy()
    meta[:, 0] = [ptr(m) for m in srcs]
    KERNEL(dev, meta.ctypes.data, len(srcs), ptr(plan["starts"]), ptr(plan["counts"]),
           ptr(plan["weights"]), ptr(plan["spans"]), ptr(plan["order"]), len(plan["order"]),
           k, c, n_cells, ptr(out), smem, stream(out))
    return out


def anchor_resample_feats(fmap, fh, fw, out=None):
    """One map's rows: `anchor_resample_bank` of one (fh, fw) scale of one
    (1, h, w, C) map, (fh * fw, C). `out`: an optional contiguous (fh * fw,
    C) place for the rows."""
    return anchor_resample_bank([fmap], [(fh, fw)], [0], None if out is None else out[None],
                                stride=1)[0]
