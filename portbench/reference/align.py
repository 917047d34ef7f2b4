"""Plain reference of the alignment configuration: one pair at a time, in
plain PyTorch, written from RANSAC-Flow's published method (Shen et al.,
ECCV 2020) and the reference implementation's semantics: the Lanczos-3
source pyramid, the ResNet-50 layer3 trunk over every scale, dense mutual
nearest-neighbour matching of cell features, RANSAC of 4-point homographies
(target cell -> source cell, normalized coordinates), the homography warp
of the middle scale, the fine feature extractor, both local correlation
volumes, the flow and matchability heads, and the composed flow and
cycle-consistent matchability.

It imports nothing of the program. `align_pair` runs the whole pipeline
(the control puts it, at a lower precision, in the program's place);
`fine_stage` runs the fine stage from a given homography, which the judge
(`portbench/judges/align.py`) uses to check the program's fine outputs at
the program's own H21.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import nets


# ------------------------------------------------------------- pyramid

def _lanczos3(x):
    y = 3.0 * torch.sin(math.pi * x) * torch.sin(math.pi * x / 3.0)
    w = torch.where(x > 1e-3, y / torch.where(x != 0, math.pi ** 2 * x ** 2, 1.0), 1.0)
    return torch.where(x > 3.0, 0.0, w)


def lanczos_weights(in_size, out_size, device):
    """(in, out) weights of an antialiased Lanczos-3 resize along one axis
    (`jax.image.resize`: half-pixel centres, the kernel widened by the
    inverse scale on downscale, columns normalized, outside samples 0)."""
    f32 = torch.float32
    inv = torch.full((), 1.0 / (out_size / in_size), dtype=f32, device=device)
    kscale = torch.clamp_min(inv, 1.0)
    sample = (torch.arange(out_size, dtype=f32, device=device) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=f32, device=device)[:, None]).abs()
    w = _lanczos3(x / kscale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def pyramid(image, shapes):
    """(B, H, W, 3) -> tuple of (B, h, w, 3), rows resized first."""
    _, h0, w0, _ = image.shape
    out = []
    for h, w in shapes:
        x = image
        if h != h0:
            x = torch.einsum("bhwc,hH->bHwc", x, lanczos_weights(h0, h, x.device))
        if w != w0:
            x = torch.einsum("bhwc,wW->bhWc", x, lanczos_weights(w0, w, x.device))
        out.append(x.contiguous())
    return tuple(out)


# ------------------------------------------------------------- coarse stage

def cell_coords(h, w, device):
    """(h*w, 2) cell-centred normalized (x, y), row-major."""
    ys = ((torch.arange(h, device=device, dtype=torch.float32) + 0.5) / h - 0.5) * 2.0
    xs = ((torch.arange(w, device=device, dtype=torch.float32) + 0.5) / w - 0.5) * 2.0
    return torch.stack([xs.repeat(h), ys.repeat_interleave(w)], dim=1)


def coarse_features(trunk, img, mm):
    """(1, H, W, 3) -> (H/16 * W/16, 1024) L2-normalized rows."""
    f = nets.resnet50_layer3(trunk, nets.imagenet_preprocess(img), mm)
    return nets.l2_normalize(f[0].flatten(1).T, dim=1)


def coarse_matches(trunk, pyr, target, mm="exact"):
    """Mutual nearest neighbours of the target's cells in the whole
    pyramid's bank. Returns (m1 (N, 2) source coords, m2 (N, 2) target
    coords, valid (N,), margin (N,)), one row per target cell; `margin` is
    the smaller of the score's lead over the runner-up in the cell's column
    and in its best source row: where it is a rounding's size, two fp32
    computations of the features may pick different matches."""
    dev = target.device
    bank = torch.cat([coarse_features(trunk, s, mm) for s in pyr])
    coords_a = torch.cat([cell_coords(s.shape[1] // 16, s.shape[2] // 16, dev) for s in pyr])
    ft = coarse_features(trunk, target, mm)
    a, b = (nets.round_tf32(bank), nets.round_tf32(ft)) if mm == "tf32" else (bank, ft)
    score = a @ b.T                                   # (nA, nB)
    best_src = score.argmax(dim=0)                    # per target cell, ties to the lowest
    rows = score[best_src]                            # the matched source rows
    cols = torch.arange(score.shape[1], device=dev)
    valid = (rows.argmax(dim=1) == cols) & (score[best_src, cols] != 0)
    col2, row2 = score.topk(2, dim=0).values, rows.topk(2, dim=1).values
    margin = torch.minimum(col2[0] - col2[1], row2[:, 0] - row2[:, 1])
    m2 = cell_coords(target.shape[1] // 16, target.shape[2] // 16, dev)
    return coords_a[best_src], m2, valid, margin


def residuals_sq(H, m1, m2):
    """Squared distance of m1 to m2 mapped by each H (n, 3, 3): (n, N)."""
    ones = torch.ones_like(m2[:, :1])
    p = torch.cat([m2, ones], dim=1)                  # (N, 3)
    ex, ey, ez = (p @ H[:, r, :].T for r in range(3))  # (N, n)
    du = ex / ez - m1[:, 0:1]
    dv = ey / ez - m1[:, 1:2]
    return (du * du + dv * dv).T


def count_inliers(H, m1, m2, valid, tolerance):
    """Inliers of each H (n, 3, 3) at `tolerance`, and the valid matches
    whose residual lies within 1e-5 of it (a last-bit change of H flips
    those), both (n,) int64."""
    r2 = residuals_sq(H, m1, m2)
    hit = (r2 < tolerance * tolerance) & valid[None]
    near = ((r2.sqrt() - tolerance).abs() <= 1e-5) & valid[None]
    return hit.sum(1), near.sum(1)


def dlt(src, dst):
    """Homographies mapping dst -> src, one per 4-point set: (n, 4, 2)
    each. Hartley-normalized DLT solved in float64 (null vector by SVD),
    returned in float32 with H[2, 2] = 1 where finite."""
    def normalize(p):
        c = p.mean(dim=1, keepdim=True)
        d = (p - c).norm(dim=2).mean(dim=1).clamp_min(1e-12)
        s = math.sqrt(2.0) / d
        T = torch.zeros(p.shape[0], 3, 3, dtype=p.dtype, device=p.device)
        T[:, 0, 0] = s
        T[:, 1, 1] = s
        T[:, 0, 2] = -s * c[:, 0, 0]
        T[:, 1, 2] = -s * c[:, 0, 1]
        T[:, 2, 2] = 1.0
        return T, (p - c) * s[:, None, None]

    src, dst = src.double(), dst.double()
    ts, s = normalize(src)
    td, d = normalize(dst)
    n = src.shape[0]
    A = torch.zeros(n, 8, 9, dtype=torch.float64, device=src.device)
    u, v, x, y = d[..., 0], d[..., 1], s[..., 0], s[..., 1]
    A[:, 0::2, 0], A[:, 0::2, 1], A[:, 0::2, 2] = -u, -v, -1.0
    A[:, 0::2, 6], A[:, 0::2, 7], A[:, 0::2, 8] = x * u, x * v, x
    A[:, 1::2, 3], A[:, 1::2, 4], A[:, 1::2, 5] = -u, -v, -1.0
    A[:, 1::2, 6], A[:, 1::2, 7], A[:, 1::2, 8] = y * u, y * v, y
    h = torch.linalg.svd(A).Vh[:, -1].view(n, 3, 3)
    H = torch.linalg.inv(ts) @ h @ td
    H = H / H[:, 2:3, 2:3]
    return H.float()


def ransac(m1, m2, valid, tolerance, n_iter, generator):
    """Fixed-count RANSAC with its own draws: `n_iter` 4-point sets drawn
    uniformly from the valid matches (a set with a repeated match scores
    0), each solved and scored; the first best wins. Returns (H21, count,
    found)."""
    idx = valid.nonzero()[:, 0]
    if idx.numel() < 4:
        eye = torch.eye(3, device=m1.device)
        return eye, 0, False
    r = torch.randint(0, idx.numel(), (n_iter, 4), generator=generator,
                      device=generator.device).to(m1.device)
    sets = idx[r]
    H = dlt(m1[sets], m2[sets])
    counts = torch.zeros(n_iter, dtype=torch.int64, device=m1.device)
    for lo in range(0, n_iter, 2048):
        counts[lo:lo + 2048] = count_inliers(H[lo:lo + 2048], m1, m2, valid, tolerance)[0]
    distinct = (sets[:, :, None] == sets[:, None, :]).sum(dim=(1, 2)) == 4
    ok = distinct & torch.isfinite(H).all(dim=(1, 2)) & (torch.linalg.det(H).abs() > 1e-6)
    counts = torch.where(ok, counts, 0)
    best = int(counts.argmax())
    return H[best], int(counts[best]), int(counts[best]) > 0


# ------------------------------------------------------------- fine stage

def warp_grid(H, h, w):
    """(1, h, w, 2): the corner-anchored target grid mapped through H."""
    xs = torch.linspace(-1.0, 1.0, w, device=H.device)
    ys = torch.linspace(-1.0, 1.0, h, device=H.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    p = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).view(-1, 3)
    q = p @ H.T
    return (q[:, :2] / q[:, 2:3]).view(1, h, w, 2)


def sample(img_nhwc, grid):
    """Bilinear, align_corners=True, zeros outside: (B, h, w, C)."""
    out = F.grid_sample(img_nhwc.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1)


def upsample(x_nhwc, h, w):
    """Bilinear resize, align_corners=False, (B, h, w, C)."""
    out = F.interpolate(x_nhwc.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                        align_corners=False)
    return out.permute(0, 2, 3, 1)


def fine_features(fine, img, mm):
    """(1, H, W, 3) -> NCHW L2-normalized (1, 256, H/8, W/8)."""
    return nets.l2_normalize(nets.feature_extractor(fine, img.permute(0, 3, 1, 2), mm=mm),
                             dim=1)


def fine_stage(fine, src, target, H, kernel_size=7, mm="exact"):
    """The fine stage of one pair at the homography H (target -> source):
    returns flow (Ht, Wt, 2), match (Ht, Wt), flow_down8 (h8, w8, 2) and
    match_down8 (h8, w8, 2) with cycle-consistent matchability, before any
    gating on RANSAC's failure."""
    ht, wt = target.shape[1:3]
    grid_c = warp_grid(H, ht, wt)
    warped = sample(src, grid_c)
    ft = fine_features(fine["netFeatCoarse"], target, mm)
    fs = fine_features(fine["netFeatCoarse"], warped, mm)
    if mm == "tf32":
        ft, fs = nets.round_tf32(ft), nets.round_tf32(fs)
    corr12 = nets.correlation(ft, fs, kernel_size)
    corr21 = nets.correlation(fs, ft, kernel_size)
    flow8 = nets.flow_epilogue(nets.head(fine["netFlowCoarse"], corr12, mm=mm), kernel_size)
    m12 = torch.sigmoid(nets.head(fine["netMatch"], corr12, mm=mm)).permute(0, 2, 3, 1)
    m21 = torch.sigmoid(nets.head(fine["netMatch"], corr21, mm=mm)).permute(0, 2, 3, 1)
    ident = warp_grid(torch.eye(3, device=H.device), ht, wt)
    flow_up = (upsample(flow8, ht, wt) + ident).clamp(-1.0, 1.0)
    sampled = sample(torch.cat([grid_c, upsample(m21, ht, wt)], dim=-1), flow_up)
    flow12 = sampled[..., :2]
    match = upsample(m12, ht, wt) * sampled[..., 2:3]
    inside = ((flow12 >= -1) & (flow12 <= 1)).all(dim=-1, keepdim=True)
    match = (match * inside.to(match.dtype))[..., 0]
    return {"flow": flow12[0], "match": match[0], "flow_down8": flow8[0],
            "match_down8": torch.cat([m12, m21], dim=-1)[0]}


def gated(out, found, ht, wt):
    """The serving path's outputs for a pair whose RANSAC failed: identity
    flow, zero matchability and residuals."""
    if found:
        return out
    ident = warp_grid(torch.eye(3, device=out["flow"].device), ht, wt)[0]
    return {"flow": ident, "match": torch.zeros_like(out["match"]),
            "flow_down8": torch.zeros_like(out["flow_down8"]),
            "match_down8": torch.zeros_like(out["match_down8"])}


def align_pair(trunk, fine, source, target, shapes, tolerance, n_iter, generator,
               kernel_size=7, mm="exact"):
    """The whole pipeline for one pair, (1, Hs, Ws, 3) source and (1, Ht, Wt,
    3) target: the control's stand-in for the program. Returns the serving
    path's fields for the pair."""
    pyr = pyramid(source, shapes)
    m1, m2, valid, _ = coarse_matches(trunk, pyr, target, mm)
    H, count, found = ransac(m1, m2, valid, tolerance, n_iter, generator)
    H = H if found else torch.eye(3, device=H.device)
    out = fine_stage(fine, pyr[len(pyr) // 2], target, H, kernel_size, mm)
    out = gated(out, found, *target.shape[1:3])
    return {"H21": H, "found": found, "num_inliers": count, **out}


def to_numpy(out):
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in out.items()}
