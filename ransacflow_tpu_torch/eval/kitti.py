"""KITTI 2015 optical-flow harness, EPE over the 200 training pairs (port of
`ransacflow_tpu/eval/kitti.py`).

Prediction mirrors evaluation/evalKITTI/evaluation.py:220-344: coarse
matching at coarseSize 800 (3 scales, scaleR 1.2, 50k hypotheses), then a
two-resolution fine refinement: a fine pass at fineSize // 2 (kernel 5's
homography form), its stride-8 flow composed by kernel 8 into a new coarse
grid at fineSize, then a second fine pass on that grid (kernel 5's grid
form) composed by kernel 8 at the original resolution, with the
connected-component cleanup of the matchability on the host. Metrics mirror
getResults.py:95-141,201-235: the three-level composition (H -> d2 flow ->
full flow) at the ground truth's resolution, two kernel 8 calls a pair, the
cc cleanup, the first-accept merge, the optional nearest fill, and the EPE
against the 16-bit PNG ground truth ((v - 2^15) / 64), read without cv2.
"""

import os
import struct
import zlib

import numpy as np
import torch
from PIL import Image

from ransacflow_tpu_torch.device import as_device
from ransacflow_tpu_torch.eval.artifacts import load_pair, save_pair
from ransacflow_tpu_torch.eval.compose import (
    fill_flow_nearest,
    match_channels,
    merge_multi_h,
    put,
    remove_small_cc,
)
from ransacflow_tpu_torch.kernels.compose import compose_tail
from ransacflow_tpu_torch.ops.grid import normalized_grid
from ransacflow_tpu_torch.ops.homography import warp_grid
from ransacflow_tpu_torch.pipeline.coarse import CoarseAligner
from ransacflow_tpu_torch.pipeline.fine import (
    fine_features,
    pred_flow_mask,
    pred_flow_mask_homography,
)
from ransacflow_tpu_torch.utils.image import resize_round_stride, to_array

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _unfilter(kinds, filtered, bpp):
    """Undo PNG's per-row filters (None, Sub, Up, Average, Paeth).

    kinds: (h,) filter type of each row; filtered: (h, w * bpp) uint8.
    A byte depends on the one bpp to its left, the one above and the one
    above-left, so the pixels of an anti-diagonal are independent: one
    numpy step per anti-diagonal, every row's filter applied at once.
    """
    if np.any(kinds > 4):
        raise ValueError(f"PNG: unknown filter type {int(kinds.max())}")
    h, stride = filtered.shape
    w = stride // bpp
    f = filtered.reshape(h, w, bpp).astype(np.int32)
    k = kinds.astype(np.intp)
    out = np.zeros((h + 1, w + 1, bpp), np.int32)  # a zero row above, a zero pixel left
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]  # left, up, up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(k[y][:, None], [np.zeros_like(a), a, b, (a + b) >> 1, paeth])
        out[y + 1, x + 1] = (f[y, x] + pred) & 255
    return out[1:, 1:].reshape(h, stride).astype(np.uint8)


def read_png16(path):
    """A 16-bit RGB PNG (KITTI's ground truth) as `cv2.imread(path,
    cv2.IMREAD_UNCHANGED)` gives it: uint16 (H, W, 3) in B, G, R order.
    zlib and numpy only: PIL truncates 16-bit RGB to 8 bits. Raises
    ValueError on other bit depths and colour types (palettes included),
    interlaced files and damaged chunks."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat, pos = None, [], 8
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 16:
        raise ValueError(f"{path}: bit depth {depth}, expected 16")
    if colour != 2:
        raise ValueError(f"{path}: colour type {colour}, expected 2 (RGB)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG files are not read")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * 6 + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for {w}x{h} RGB")
    rows = raw.reshape(h, w * 6 + 1)
    pix = _unfilter(rows[:, 0], rows[:, 1:], 6).reshape(h, w, 3, 2)
    img = (pix[..., 0].astype(np.uint16) << 8) | pix[..., 1]  # big-endian samples
    return np.ascontiguousarray(img[..., ::-1])  # cv2's B, G, R


def read_kitti_flow(path):
    """16-bit PNG flow ground truth -> (u, v, valid) (getResults.py:17-24):
    the file stores R, G, B = u, v, valid."""
    raw = read_png16(path)
    valid, v, u = raw[:, :, 0], raw[:, :, 1], raw[:, :, 2]
    u = (u.astype(float) - 32768) / 64.0
    v = (v.astype(float) - 32768) / 64.0
    return u, v, valid.astype(bool)


def _compose(flow_down8, base_grid):
    """clamp(upsample(flow_down8) + grid) sampled from base_grid, at its size:
    kernel 8's flow without cycle matching (its match is not used)."""
    unused = torch.zeros(flow_down8.shape[:3] + (1,), device=flow_down8.device)
    return compose_tail(flow_down8, unused, unused, base_grid, False)[0]


def predict_kitti(
    image_dir,
    out_dir,
    resnet,
    align_params,
    device,
    coarse_size=800,
    fine_size=650,
    nb_scale=3,
    scale_r=1.2,
    n_iter=50000,
    tolerance=0.05,
    mask_region_th=0.005,
    cc_th=0.01,
    begin_index=0,
    end_index=200,
    seed=1000,
    bg_mask_fn=None,
    max_coarse=None,
    adaptive_chunk=0,
    anchor_stride=0,
    relax_cells=0,
):
    """Predict flow for pairs ({i:06}_10.png target, {i:06}_11.png source).

    The RANSAC draws are reseeded per pair index (`CoarseAligner.reseed`),
    so a begin_index/end_index restart writes the full run's artifacts.
    (The reference seeds once globally, evalKITTI/evaluation.py:182-183.)
    """
    coarse = CoarseAligner(
        resnet, device, nb_scale=nb_scale, n_iter=n_iter, tolerance=tolerance,
        min_size=coarse_size, scale_r=scale_r, resize_mode="min", seed=seed,
        adaptive_chunk=adaptive_chunk, anchor_stride=anchor_stride,
        relax_cells=relax_cells,
    )
    for i in range(begin_index, end_index):
        _predict_one_kitti_pair(
            coarse, align_params, image_dir, out_dir, i,
            fine_size=fine_size, mask_region_th=mask_region_th, cc_th=cc_th,
            seed=seed, bg_mask_fn=bg_mask_fn, max_coarse=max_coarse,
        )


def pooled_kitti_predict(
    image_dir,
    out_dir,
    resnet,
    align_params,
    devices,
    coarse_size=800,
    fine_size=650,
    nb_scale=3,
    scale_r=1.2,
    n_iter=50000,
    tolerance=0.05,
    mask_region_th=0.005,
    cc_th=0.01,
    begin_index=0,
    end_index=200,
    seed=1000,
    bg_mask_fn=None,
    max_coarse=None,
    adaptive_chunk=0,
    anchor_stride=0,
    relax_cells=0,
):
    """`predict_kitti` over a pool of slots (`eval.pooled.make_device_pool`
    on `devices`), one worker thread a slot. KITTI's accept decision runs
    the connected-component cleanup on the host at every iteration, so the
    loop cannot live on the device; each worker runs the sequential pair
    procedure on its own aligner, the pair indices striped over the
    workers. Each pair's draws depend on its index alone
    (`CoarseAligner.reseed`), so the artifacts are the sequential pass's
    for any pool size."""
    from ransacflow_tpu_torch.eval.pooled import make_device_pool
    from ransacflow_tpu_torch.parallel.mesh import per_device

    pool = make_device_pool(
        resnet, align_params, devices,
        dict(nb_scale=nb_scale, n_iter=n_iter, tolerance=tolerance,
             min_size=coarse_size, scale_r=scale_r, resize_mode="min", seed=seed,
             adaptive_chunk=adaptive_chunk, anchor_stride=anchor_stride,
             relax_cells=relax_cells))
    kwargs = dict(fine_size=fine_size, mask_region_th=mask_region_th, cc_th=cc_th,
                  seed=seed, bg_mask_fn=bg_mask_fn, max_coarse=max_coarse)

    def worker(w, _device):
        aligner, nets = pool[w]
        for i in range(begin_index + w, end_index, len(pool)):
            _predict_one_kitti_pair(aligner, nets, image_dir, out_dir, i, **kwargs)

    per_device(devices, worker)


@torch.inference_mode()
def _predict_one_kitti_pair(
    coarse, align_params, image_dir, out_dir, i, *,
    fine_size, mask_region_th, cc_th, seed, bg_mask_fn, max_coarse,
):
    """One pair's two-resolution prediction. The loop stays on the host: the
    accept decision runs scipy's connected-component cleanup on the
    matchability, read back at every iteration."""
    tgt_path = os.path.join(image_dir, f"{i:06}_10.png")
    i_s = Image.open(os.path.join(image_dir, f"{i:06}_11.png")).convert("RGB")
    i_t = Image.open(tgt_path).convert("RGB")

    it_resize = resize_round_stride(i_t, fine_size, stride=8)
    it_d2 = resize_round_stride(i_t, fine_size // 2, stride=8)

    src = coarse.put(to_array(i_s))[None]
    tgt_resize = coarse.put(to_array(it_resize))[None]
    tgt_d2 = coarse.put(to_array(it_d2))[None]
    w_org, h_org = i_t.size
    h_rs, w_rs = tgt_resize.shape[1:3]
    h_d2, w_d2 = tgt_d2.shape[1:3]

    coarse.set_pair(i_s, i_t)
    coarse.reseed(i, seed=seed)  # the pair's own draws, whatever the order
    if bg_mask_fn is not None:
        bg = bg_mask_fn(tgt_path, (h_org, w_org))
    else:
        bg = np.ones((h_org, w_org), np.float32)

    featt_d2 = fine_features(align_params, tgt_d2)
    featt_rs = fine_features(align_params, tgt_resize)

    mask = np.zeros((h_org, w_org), np.float32)
    hs, flows_d2, flows_full, matches_full = [], [], [], []
    nb_coarse = 0
    while True:
        fg = ((mask + (1.0 - bg)) > 0.5).astype(np.float32)
        H, _ = coarse.get_coarse(fg)
        if H is None:
            break
        h_dev = coarse.put(H)[None]
        # pass 1: fine flow at half resolution, warped and composed at its size
        out_d2 = pred_flow_mask_homography(align_params, src, featt_d2, h_dev,
                                           (h_d2, w_d2), cycle_match=True)
        # compose the d2 stride-8 flow into a new coarse grid at fineSize
        flow_coarse = _compose(out_d2["flow_down8"], warp_grid(h_dev, h_rs, w_rs))
        # pass 2: fine at fineSize on that grid, composed at the original size
        out_full = pred_flow_mask(align_params, src, featt_rs, flow_coarse,
                                  cycle_match=True, out_hw=(h_org, w_org))
        match_fine = remove_small_cc(out_full["match"].float().cpu().numpy(), cc_th,
                                     match_th=0.99)

        accept = ((match_fine > 0.9999) * (1.0 - fg)).mean() > mask_region_th
        if accept or nb_coarse == 0:
            hs.append(H)
            flows_d2.append(out_d2["flow_down8"][0].float().cpu().numpy())
            flows_full.append(out_full["flow_down8"][0].float().cpu().numpy())
            matches_full.append(out_full["match_down8"][0].float().cpu().numpy())
            nb_coarse += 1
            match_fine = match_fine * (1.0 - fg)
            mask = ((mask + match_fine) > 0.9999).astype(np.float32)
            if max_coarse is not None and nb_coarse > max_coarse:
                break
        else:
            break

    if hs:
        save_pair(
            out_dir, i,
            {
                "coarse_h": np.stack(hs),
                "fine_flow_down8": np.stack(flows_full),
                "fine_match_down8": np.stack(matches_full),
                "bg_mask": bg.astype(bool),
            },
            fine_flow_d2_down8=np.stack(flows_d2),
        )


@torch.inference_mode()
def compose_kitti_flow(art, ht, wt, device, th=1.0, cc_th=0.01, multi_h=True,
                       interpolate=False, only_coarse=False):
    """One pair's three-level flow composition at the ground truth's
    resolution on `device`: the stride-8 d2 flow into the homography grid,
    the full stride-8 flow into that with cycle matchability (one kernel 8
    call each, the n homographies a batch), the cc cleanup, the first-accept
    merge and the optional nearest fill (reference getResults.py:95-151
    getFlow_all / getFlow_onlyCoarse).

    Returns the absolute normalized sampling grid (ht, wt, 2).
    """
    device = as_device(device)
    n = art["coarse_h"].shape[0]
    h_grid = warp_grid(put(art["coarse_h"], device), ht, wt)
    if only_coarse:
        return h_grid[0].cpu().numpy()
    # level 2: the d2 stride-8 flow into the homography grid
    flow_d2 = _compose(put(art["fine_flow_d2_down8"], device), h_grid)
    # level 3: the full stride-8 flow into the d2-composed grid
    flow_full, match = compose_tail(put(art["fine_flow_down8"], device),
                                    *match_channels(put(art["fine_match_down8"], device)),
                                    flow_d2, True)
    match = match.cpu().numpy()
    match = np.stack([remove_small_cc(match[j], cc_th) for j in range(n)])
    flows = np.clip(flow_full.cpu().numpy(), -1, 1)
    merged = merge_multi_h(flows, match, th, multi_h)
    flow = merged["flow"]
    if interpolate:
        flow = fill_flow_nearest(flow, merged["match_binary"])
    return flow


def evaluate_kitti(
    pred_dir,
    gt_dir,
    device,
    n_pairs=200,
    multi_h=True,
    th=1.0,
    cc_th=0.01,
    interpolate=False,
    only_coarse=False,
):
    """Mean EPE over the training pairs, composed on `device`. Returns
    (mean, per-pair list)."""
    epes = []
    for i in range(n_pairs):
        u, v, valid = read_kitti_flow(os.path.join(gt_dir, f"{i:06}_10.png"))
        ht, wt = u.shape
        grid = normalized_grid(ht, wt, "cpu").numpy()

        art = load_pair(pred_dir, i)
        if art is None:
            flow = grid
        else:
            flow = compose_kitti_flow(
                art, ht, wt, device, th=th, cc_th=cc_th, multi_h=multi_h,
                interpolate=interpolate, only_coarse=only_coarse,
            )

        du = (flow[..., 0] - grid[..., 0]) * (wt - 1) / 2
        dv = (flow[..., 1] - grid[..., 1]) * (ht - 1) / 2
        err = np.sqrt((du - u) ** 2 + (dv - v) ** 2)
        epes.append(float((err * valid).sum() / valid.sum()))
    return float(np.mean(epes)), epes
