"""Kernel 1: the Lanczos-3 scale pyramid (`csrc/pyramid.cu`)."""

import ctypes
import math

import numpy as np
import torch

from ransacflow_tpu_torch.kernels.build import Kernel, check, forbid_grad, ptr, stream

LANCZOS_RADIUS = 3.0
STRIP_WIDTHS = (64, 48, 32, 16)  # output columns a block may own, widest first
MAX_SPAN_FLOATS = 256           # floats of an input row a strip should stage at most
MAX_BAND_ROWS = 64              # output rows a block may own
BLOCK_SMEM = 55 * 1024          # shared bytes a block should take: 4 blocks an SM
MAX_SMEM = 227 * 1024           # shared memory a block can have on the H100
MAX_SCALES = 16                 # kMaxScales: rows of the per-scale table
# the per-scale fields of `schedule`'s meta, in the order of the source's enum
META = ("h", "w", "row_idx", "row_w", "row_t", "col_idx", "col_w", "col_t", "out",
        "block0", "n_strips", "strip_w", "band_rows", "stride", "strip", "band")
KERNEL = Kernel("rf_lanczos_pyramid",
                [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
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


def _strip_width(cs, cc, W):
    """The widest of STRIP_WIDTHS whose strips each stage at most
    MAX_SPAN_FLOATS floats of a row (the narrowest when none does)."""
    for sw in STRIP_WIDTHS:
        if all(_span(cs, cc, x0, sw, W)[1] <= MAX_SPAN_FLOATS
               for x0 in range(0, len(cs), sw)):
            return sw
    return STRIP_WIDTHS[-1]


def _span(cs, cc, x0, sw, W):
    """(q0, nq): the floats of an input row (W * 3 of them, channels last)
    that the output columns [x0, x0 + sw) read, widened to multiples of 4
    (16-byte copies) within the row; (0, 0) when none reads a column."""
    live = cc[x0:x0 + sw] > 0
    if not live.any():
        return 0, 0
    c0 = int(cs[x0:x0 + sw][live].min())
    c1 = int((cs[x0:x0 + sw] + cc[x0:x0 + sw])[live].max())
    q0 = 3 * c0 // 4 * 4
    return q0, min(-(-3 * c1 // 4) * 4, 3 * W) - q0


def _bands(rs, rc, h, bh):
    """(lo, n) per band of `bh` output rows: the input rows [lo, lo + n) that
    the band's rows read ((0, 0) when none reads a row)."""
    out = []
    for y0 in range(0, h, bh):
        live = rc[y0:y0 + bh] > 0
        if not live.any():
            out.append((0, 0))
            continue
        lo = int(rs[y0:y0 + bh][live].min())
        out.append((lo, int((rs[y0:y0 + bh] + rc[y0:y0 + bh])[live].max()) - lo))
    return out


def _smem(n_rows, bh, stride, sw, col_t, row_t):
    """Shared bytes of a block: its staged input rows, its intermediate rows
    (whole quads), its column and row weights, offsets and counts (see
    csrc/pyramid.cu)."""
    return 4 * ((n_rows + -(-bh // 4) * 4) * stride + sw * col_t + bh * row_t
                + 2 * sw + 2 * bh)


def schedule(H, W, shapes):
    """K1's launch schedule for (H, W) into the non-identity `shapes`, as
    numpy arrays (the wrapper keeps them on the device).

    Each block owns one scale's strip of `strip_w` output columns and a band
    of `band_rows` output rows of one image. It stages every input row that
    the band reads (the floats [q0, q0 + nq) of each) into shared memory in
    one go, runs the band's vertical taps from there into intermediate rows,
    then their horizontal taps. The strip is the widest of STRIP_WIDTHS
    whose spans stay within MAX_SPAN_FLOATS, the band the tallest (up to
    MAX_BAND_ROWS) whose block fits BLOCK_SMEM. Returns meta (one row of
    META fields per scale), the taps (starts, counts, weights: per scale its
    rows', then its columns'), strips ((q0, nq) per strip), bands ((lo, n)
    per band), n_blocks, n_out (floats per image) and smem (bytes, the
    largest block's)."""
    out = {k: [] for k in ("meta", "starts", "counts", "weights", "strips", "bands")}
    n = dict.fromkeys(("idx", "w", "out", "block0", "strip", "band"), 0)
    smem = 0
    for h, w in shapes:
        rs, rc, rw = taps(H, h)
        cs, cc, cw = taps(W, w)
        sw = _strip_width(cs, cc, W)
        spans = [_span(cs, cc, x0, sw, W) for x0 in range(0, w, sw)]
        stride = -(-max(nq for _, nq in spans) // 4) * 4
        for bh in range(min(MAX_BAND_ROWS, h), 0, -1):
            bands = _bands(rs, rc, h, bh)
            need = _smem(max(k for _, k in bands), bh, stride, sw, cw.shape[1], rw.shape[1])
            if need <= BLOCK_SMEM or bh == 1:
                break
        m = dict(h=h, w=w, row_idx=n["idx"], row_w=n["w"], row_t=rw.shape[1],
                 col_idx=n["idx"] + h, col_w=n["w"] + rw.size, col_t=cw.shape[1],
                 out=n["out"], block0=n["block0"], n_strips=len(spans), strip_w=sw,
                 band_rows=bh, stride=stride, strip=n["strip"], band=n["band"])
        out["meta"].append([m[f] for f in META])
        out["starts"] += [rs, cs]
        out["counts"] += [rc, cc]
        out["weights"] += [rw.ravel(), cw.ravel()]
        out["strips"].append(np.array(spans, np.int32).ravel())
        out["bands"].append(np.array(bands, np.int32).ravel())
        smem = max(smem, need)
        n["idx"] += h + w
        n["w"] += rw.size + cw.size
        n["out"] += h * w * 3
        n["block0"] += len(spans) * len(bands)
        n["strip"] += 2 * len(spans)
        n["band"] += 2 * len(bands)
    if smem > MAX_SMEM:
        raise ValueError(f"device_pyramid: {smem} bytes of shared memory > {MAX_SMEM}")
    plan = {k: np.concatenate(v) for k, v in out.items() if k != "meta"}
    plan["meta"] = np.array(out["meta"], np.int64)
    plan.update(n_blocks=n["block0"], n_out=n["out"], smem=smem)
    return plan


def _plan(H, W, shapes, device):
    """`schedule` on the device (its per-scale table stays on the host: the
    launch passes it as a kernel parameter), built once per input size,
    scales and device and kept."""
    key = (H, W, tuple(shapes), device)
    if key not in _plans:
        plan = schedule(H, W, shapes)
        for name in ("starts", "counts", "weights", "strips", "bands"):
            plan[name] = torch.from_numpy(plan[name]).to(device)
        _plans[key] = plan
    return _plans[key]


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
    if len(todo) > MAX_SCALES:
        raise ValueError(f"device_pyramid: at most {MAX_SCALES} scales besides the input's")
    if todo:
        plan = _plan(H, W, todo, image.device)
        # the scales back to back, each (B, h, w, 3)
        out = torch.empty(B * plan["n_out"], dtype=torch.float32, device=image.device)
        if out.numel() >= 2**31 or image.numel() >= 2**31:
            raise ValueError("device_pyramid: tensors must hold fewer than 2^31 elements")
        KERNEL(image.device, ptr(image), ptr(out), plan["meta"].ctypes.data,
               ptr(plan["starts"]), ptr(plan["counts"]), ptr(plan["weights"]),
               ptr(plan["strips"]), ptr(plan["bands"]),
               len(todo), plan["n_blocks"], B, H, W, plan["smem"], stream(image))
        offset = 0
        for h, w in todo:
            done[(h, w)] = out[offset:offset + B * h * w * 3].view(B, h, w, 3)
            offset += B * h * w * 3
    return tuple(image if (h, w) == (H, W) else done[(h, w)] for h, w in shapes)
