#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port once on one CUDA card: the serving path,
the multi-homography loop, training, the opt-in fast modes through the
public entry points, and the sky mask.

    python3 chip_smoke.py

Phases, each of which must pass:
  (a) card: a CUDA device is present; prints its name and power limit;
  (b) build: compiles the CUDA kernels from `ransacflow_tpu_torch/csrc/`;
  (c) kernels: each hand-written kernel (K1-K13, K5 in its grid and its
      homography form, the backward kernels of K6, K7, K9 and K10 under
      their own names, and K2 with relax_cells 1) against its plain PyTorch
      version at its path's shapes (K1 the serving pyramid, K5's homography
      form the fine stage's 480x640 warp, K12 a serving pair's four anchor
      resamples, K13 the sky mask's conv5 maps, the backward kernels and
      K9-K11 the full-width training step's; K11 at the step's three calls,
      each on a per-pixel-noise grid and an upsampled random flow's grid,
      with the share of its tiles that splatted through shared memory, at
      least 90% on the latter at C = 1 and 2), with max
      error, paired times (CUDA events and profiler device time), the time
      of one PyTorch call that computes the same function where there is one
      (`library_ms`), and the least time the card could take for the work
      (`bound_ms`: bytes over 3.35 TB/s or operations over 67 TFLOP/s fp32,
      whichever is larger); K4 runs under sync-debug 'error';
  (d) serving path: `fused_align_batch` over 4 pairs at full width (480x640
      targets, 7-scale pyramid from 960x1280, 10k RANSAC hypotheses, fp32,
      seeded weights), checked for finite outputs, against the plain CPU path
      on a small pair, and for launches of its kernels: lanczos_pyramid (K1),
      mutual_argmax (K2), ransac_score (K3), warp_homography (K5, one per
      pair, and no grid-form warp_sample), correlation_volume (K6),
      head_epilogues (K7), compose_tail (K8) and blur_pool (K9); prints
      pairs/s;
  (e) multi-homography path: `_fused_multi_homo_batch` at bench.py's
      HPatches configuration (4 related pairs, 480x640 targets, 7-scale
      pyramid from 960x1280, max_coarse 10, mask_region_th 0.01, match12
      only, cached matching, seeded trunk, alignment nets from
      scripts/assets/accept_weights.npz), once with adaptive RANSAC (blocks
      of 4096, cap 50k) and once with 50k fixed hypotheses, checked for
      finite outputs, 1 <= count <= 11 and launches of the serving path's
      kernels and ransac_adaptive (K4); prints pairs/s, homographies and
      hypotheses per fit and a one-slot stage split (the slot's warp timed
      both ways in turns: warp_grid + the grid form, and warp_homography);
      then, on one pair
      from PIL images, the host loop (`CoarseAligner` +
      `multi_homography_predict`) and the device loop through
      `multi_homography_predict_fused` on the same aligner and seed, whose
      first homographies must agree within 0.01;
  (f) training: one small stage-3 step (IMG 32, B 2) on the card against the
      port on the CPU (losses and every gradient); stage 3 at full width (16
      pairs of 224x224, margin 88, k 7, Adam 2e-4, betas (0.5, 0.999)):
      finite losses, launches of every training kernel (K5, K6, K7, K9,
      K10, K11 and the backward kernels), K11's shared-tile share in the
      step, the median step time of 12
      CUDA-event-timed steps after warm-up, trained pairs/s, peak memory and
      a profiler breakdown of one step; one stage-1 step; then
      `python -m ransacflow_tpu_torch.cli.train --stage 3 ... NoVal` for 2
      full-width steps on synthetic JPEG groups, its checkpoint loaded back;
  (g) fast modes: the 4 serving pairs of (d) through `fused_align_batch` at
      anchor stride 3 with relax_cells 1 (fixed 10k and adaptive 4096),
      timed best of 3 in turns with the exact mode; `RansacFlowAligner.
      align_images` on a 480x640 pair (quick-start defaults, anchor 3, relax
      1, adaptive 4096); `python -m ransacflow_tpu_torch.cli.align ...
      --device cuda` in those modes (rc 0, its five outputs); the device
      multi-homography loop with relax_cells 1 against the host loop on (e)'s
      first pair; launches of the serving kernels, anchor_resample (K12)
      and ransac_adaptive (K4);
  (h) sky mask: `SkySegmenter` on the card against the CPU on a small image,
      then a seeded one at full width (5 scales of a 480x640 image, ms per
      image), and the `--segNet` hook (`cli.common.build_sky_fn` ->
      bg_mask -> `multi_homography_predict_fused`) on the 4 related pairs of
      (e); launches of ppm_pool (K13) and the loop's kernels.
Each path's launch counts are set to 0 just before it and read just after;
a kernel's `launches` is the sum over the paths. Every fine pass of an
alignment path warps through warp_homography: one launch per compose_tail
launch, and no grid-form warp_sample but align_images' warped_fine.

Its last three lines are the card (nvidia-smi name, power limit), a JSON
object with the kernels' numbers, and `{"ok": true, "device": {...}}`. It
exits non-zero, without that last line, on any failure or without CUDA.
"""

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

N_PAIRS = 4
N_ITER = 10000
TARGET_HW = (480, 640)
CORR_SHAPE = (1, 60, 80, 256)
N_BANK, N_TARGET, N_CHANNELS = 13065, 1200, 1024
MH_N_ITER, MH_CHUNK, MH_MAX_COARSE = 50000, 4096, 10  # bench.py bench_multihomo
MH_SEED = 7  # pair k of the device loop draws from seed MH_SEED + k
ACCEPT_WEIGHTS = "scripts/assets/accept_weights.npz"
SERVING_KERNELS = ("lanczos_pyramid", "mutual_argmax", "ransac_score", "warp_homography",
                   "correlation_volume", "head_epilogues", "compose_tail", "blur_pool")
MULTIHOMO_KERNELS = SERVING_KERNELS + ("ransac_adaptive",)
TRAIN_KERNELS = ("warp_sample", "grid_sample_bwd", "correlation_volume",
                 "correlation_volume_bwd", "head_epilogues", "head_epilogues_bwd",
                 "blur_pool", "blur_pool_bwd", "masked_ssim", "masked_ssim_bwd")


HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
# RANSAC arithmetic per (hypothesis, match): the homography applied (15), the
# divide (2), the squared residual (5) and the tolerance test and count (2);
# per hypothesis the Hartley normalization and the closed-form 4-point solve
RANSAC_OPS_PER_MATCH, RANSAC_OPS_PER_SOLVE = 24, 250


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps=20, warmup=3):
    """Mean milliseconds of fn() over `reps` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps=20):
    """Mean milliseconds of device time of the kernels fn() launches, from a
    torch.profiler trace of `reps` calls; None when the trace holds none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    return total_us / 1e3 / reps if total_us > 0 else None


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, n_ops, suffix=""):
    """The least time the card could take for the work (ms): the larger of
    the bytes that must move (each input read once, each output written
    once) over HBM's rate and the operations over the fp32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms" + suffix: max(t_bytes, t_ops),
            "bound_by" + suffix: "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes" + suffix: int(n_bytes), "bound_ops" + suffix: int(n_ops)}


def library(fn, suffix=""):
    """`library_ms` (CUDA events, as `ms`) and its device time: one PyTorch
    call that computes the kernel's function on the same inputs (never
    called by the port), or None where there is none."""
    if fn is None:
        return {"library_ms" + suffix: None, "library_device_ms" + suffix: None}
    return {"library_ms" + suffix: cuda_ms(fn), "library_device_ms" + suffix: device_ms(fn)}


def paired_ms(kernel_fn, plain_fn, reps=20, suffix=""):
    """Kernel and plain milliseconds per call: `ms` from CUDA events around
    back-to-back calls (host launch time included), measured in turns
    kernel, plain, plain, kernel; `device_ms` the kernels' own device time."""
    k1, p1, p2, k2 = (cuda_ms(f, reps) for f in (kernel_fn, plain_fn, plain_fn, kernel_fn))
    return {"ms" + suffix: (k1 + k2) / 2, "plain_ms" + suffix: (p1 + p2) / 2,
            "device_ms" + suffix: device_ms(kernel_fn, reps),
            "plain_device_ms" + suffix: device_ms(plain_fn, reps)}


def phase_card():
    require(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"(a) card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
          flush=True)
    return card


def phase_build():
    from ransacflow_tpu_torch.kernels import build

    build.library()
    regs = [ln.strip() for ln in build.BUILD_LOG["ptxas"].splitlines()
            if "registers" in ln]
    print(f"(b) build: {build.BUILD_LOG['seconds']:.1f} s "
          f"(compiled: {build.BUILD_LOG['built']}); ptxas: {regs}", flush=True)


def _normalized(shape, dim, gen):
    x = torch.randn(shape, generator=gen, device="cuda")
    return x / x.norm(dim=dim, keepdim=True)


def check_correlation(gen):
    from ransacflow_tpu_torch.kernels.correlation import (
        correlation_volume, correlation_volume_ref)

    x = _normalized(CORR_SHAPE, -1, gen)
    y = _normalized(CORR_SHAPE, -1, gen)
    err = 0.0
    for a, b in ((x, y), (y, x)):  # corr12 and corr21
        got = correlation_volume(a, b, 7)
        torch.cuda.synchronize()
        err = max(err, (got - correlation_volume_ref(a, b, 7)).abs().max().item())
    # fp32 sums of 256 products of unit-norm vectors, in another order
    require(err <= 1e-4, f"correlation: max abs err {err} > 1e-4")
    return {"max_abs_err": err,
            **paired_ms(lambda: correlation_volume(x, y, 7),
                        lambda: correlation_volume_ref(x, y, 7)),
            **bound(nbytes(x, y, got), 2 * got.numel() * x.shape[-1]), **library(None)}


def check_matching(gen):
    """K2 at the serving shape (13065 x 1200), exact reciprocity with a
    planted tie, then relax_cells=1 on the 30 x 40 target grid."""
    from ransacflow_tpu_torch.kernels.matching import mutual_argmax, mutual_argmax_ref

    feat_a = _normalized((N_CHANNELS, N_BANK), 0, gen)
    feat_b = _normalized((N_CHANNELS, N_TARGET), 0, gen)
    feat_a[:, 101] = feat_a[:, 57]  # bank rows 57 and 101 tie exactly ...
    feat_b[:, 5] = feat_a[:, 57]    # ... as the best source of target 5
    valid_b = torch.rand(N_TARGET, generator=gen, device="cuda") > 0.1
    valid_b[5] = True
    score = (feat_a.T @ feat_b) * valid_b.float()[None, :]
    require(score[57, 5].item() == score[101, 5].item(), "planted tie is not exact")
    out = {}
    for relax, suffix in ((0, ""), (1, "_relaxed")):
        args = (score, relax, 40 if relax else None)
        got = mutual_argmax(*args)
        want = mutual_argmax_ref(*args)
        torch.cuda.synchronize()
        for name, g, w in zip(("best_src", "best_tgt", "valid"), got[:3], want[:3]):
            require(torch.equal(g, w), f"matching{suffix}: {name} differs from the plain version")
        require(got[0][5].item() == 57, "matching: the tie did not go to the lowest index")
        require(not got[2][~valid_b].any().item(), "matching: a masked target matched")
        out["max_abs_err" + suffix] = (got[3] - want[3]).abs().max().item()
        out["n_valid" + suffix] = int(got[2].sum())
        out.update(paired_ms(lambda: mutual_argmax(*args), lambda: mutual_argmax_ref(*args),
                             suffix=suffix))
        # the score read once; a comparison per element for each argmax
        out.update(bound(nbytes(score, *got), 2 * score.numel(), suffix))
        out.update(library(lambda: (torch.argmax(score, 0), torch.argmax(score, 1)), suffix))
    require(out["n_valid_relaxed"] >= out["n_valid"], "matching: relaxing lost matches")
    return out


def _ransac_matches(gen, inlier_frac=0.6):
    """1200 target cells (30 x 40), `inlier_frac` of them inliers of a known
    homography, 10% invalid."""
    from ransacflow_tpu_torch.ops.grid import feature_cell_coords
    from ransacflow_tpu_torch.ops.homography import apply_homography

    y, x = feature_cell_coords(30, 40, "cuda")
    m2 = torch.stack([x, y, torch.ones_like(x)], dim=1)
    h_true = torch.tensor([[1.05, 0.02, 0.03], [-0.01, 0.97, -0.02],
                           [0.02, -0.03, 1.0]], device="cuda")
    m1 = apply_homography(h_true, m2[:, :2])
    m1 = m1 + 0.005 * torch.randn(m1.shape, generator=gen, device="cuda")
    outlier = torch.rand(N_TARGET, generator=gen, device="cuda") >= inlier_frac
    m1[outlier] = torch.rand((int(outlier.sum()), 2), generator=gen, device="cuda") * 2 - 1
    m1 = torch.cat([m1, torch.ones_like(m1[:, :1])], dim=1).contiguous()
    valid = torch.rand(N_TARGET, generator=gen, device="cuda") > 0.1
    return m1, m2, valid


def check_ransac(gen):
    from ransacflow_tpu_torch.kernels.ransac import ransac_score, ransac_score_ref
    from ransacflow_tpu_torch.ops.ransac import sample_minimal_sets

    m1, m2, valid = _ransac_matches(gen)
    samples = sample_minimal_sets(valid, N_ITER, gen)

    H_k, c_k = ransac_score(m1, m2, valid, samples, 0.05)
    H_r, c_r = ransac_score_ref(m1, m2, valid, samples, 0.05)
    torch.cuda.synchronize()
    agree = (c_k == c_r).float().mean().item()
    # fp32 solves in another order of operations: a match on the tolerance
    # boundary may flip, so counts must agree on >= 99.9% of hypotheses
    require(agree >= 0.999, f"ransac: counts agree on only {agree:.5f}")
    require(c_k.max().item() == c_r.max().item(), "ransac: winning counts differ")
    best_k, best_r = int(torch.argmax(c_k)), int(torch.argmax(c_r))
    err = (H_k[best_k] - H_r[best_k]).abs().max().item()
    if best_k == best_r:
        require(err <= 1e-4, f"ransac: winner H21 max abs err {err} > 1e-4")
    require(c_k.max().item() > 0.4 * N_TARGET, "ransac: no good model found")
    ops = N_ITER * (N_TARGET * RANSAC_OPS_PER_MATCH + RANSAC_OPS_PER_SOLVE)
    return {"max_abs_err": err, "counts_agree": agree,
            **paired_ms(lambda: ransac_score(m1, m2, valid, samples, 0.05),
                        lambda: ransac_score_ref(m1, m2, valid, samples, 0.05)),
            **bound(nbytes(m1, m2, valid, samples, H_k, c_k), ops), **library(None)}


def check_ransac_adaptive(gen):
    """K4 at the loop's shape: 1200 matches, blocks of 4096, cap 50k; once
    with 60% inliers (one block) and once structureless (all 13 blocks).
    The kernel's call and the whole op run under sync-debug 'error'."""
    from ransacflow_tpu_torch.kernels.ransac import ransac_score_ref
    from ransacflow_tpu_torch.kernels.ransac_adaptive import (
        ransac_adaptive, ransac_adaptive_ref)
    from ransacflow_tpu_torch.ops.ransac import (
        ransac_homography_adaptive, sample_minimal_sets)

    n_rows = -(-MH_N_ITER // MH_CHUNK) * MH_CHUNK
    out = {"max_abs_err": 0.0}
    for case, frac, want_blocks in (("clean", 0.6, 1), ("structureless", 0.0, 13)):
        m1, m2, valid = _ransac_matches(gen, frac)
        samples = sample_minimal_sets(valid, n_rows, gen)
        args = (m1, m2, valid, samples, MH_CHUNK, MH_N_ITER, 0.05, 0.999)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            H, count, sample, blocks = ransac_adaptive(*args)
            res, n_eval = ransac_homography_adaptive(m1, m2, valid, 0.05, MH_N_ITER,
                                                     MH_CHUNK, generator=gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        H_r, count_r, sample_r, blocks_r = ransac_adaptive_ref(*args)
        require(int(blocks) == int(blocks_r) == want_blocks,
                f"ransac_adaptive ({case}): {int(blocks)} blocks, plain "
                f"{int(blocks_r)}, expected {want_blocks}")
        require(int(count) == int(count_r),
                f"ransac_adaptive ({case}): count {int(count)} vs plain {int(count_r)}")
        require(int(n_eval) == want_blocks * MH_CHUNK and bool(res.found),
                f"ransac_adaptive ({case}): op evaluated {int(n_eval)}")
        # the winner against the plain solve of the same minimal set
        H_plain = ransac_score_ref(m1, m2, valid, sample[None], 0.05)[0][0]
        err = (H - H_plain).abs().max().item()
        require(err <= 1e-4, f"ransac_adaptive ({case}): H21 max abs err {err}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out[f"{case}_same_sample"] = bool(torch.equal(sample, sample_r))
        suffix = "" if case == "clean" else "_to_cap"
        out.update(paired_ms(lambda: ransac_adaptive(*args),
                             lambda: ransac_adaptive_ref(*args), reps=5, suffix=suffix))
        # the blocks this run's data needs, not the cap
        n_hyp = int(blocks) * MH_CHUNK
        out.update(bound(nbytes(m1, m2, valid, samples[:n_hyp], H, count, sample),
                         n_hyp * (N_TARGET * RANSAC_OPS_PER_MATCH + RANSAC_OPS_PER_SOLVE),
                         suffix))
        out.update(library(None, suffix))
    return out


def _homography_grid(h, w, warped):
    """(1, h, w, 2) sampling grid: the identity (every border pixel on +-1)
    or a homography that reaches past the source."""
    from ransacflow_tpu_torch.ops.homography import warp_grid

    H = torch.eye(3, device="cuda")
    if warped:
        H = torch.tensor([[1.05, 0.02, 0.1], [-0.01, 0.97, -0.05],
                          [0.02, -0.03, 1.0]], device="cuda")
    return warp_grid(H[None], h, w).contiguous()


def check_warp_sample(gen):
    """K5: the 480x640 mid scale warped onto a 480x640 grid."""
    from ransacflow_tpu_torch.kernels.warp_sample import warp_sample, warp_sample_ref

    src = torch.rand((1, *TARGET_HW, 3), generator=gen, device="cuda")
    err = 0.0
    for warped in (False, True):
        grid = _homography_grid(*TARGET_HW, warped)
        got = warp_sample(src, grid)
        torch.cuda.synchronize()
        err = max(err, (got - warp_sample_ref(src, grid)).abs().max().item())
    require(err <= 1e-5, f"warp_sample: max abs err {err} > 1e-5")
    src_nchw = src.permute(0, 3, 1, 2)
    # 4 taps of 3 channels (a multiply-add each) and ~10 for the weights
    return {"max_abs_err": err, **paired_ms(lambda: warp_sample(src, grid),
                                            lambda: warp_sample_ref(src, grid)),
            **bound(nbytes(src, grid, got), got.numel() * 8 + grid.numel() * 5),
            **library(lambda: torch.nn.functional.grid_sample(
                src_nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=True))}


def check_warp_homography(gen):
    """K5's homography form at the fine stage's shape: the 480x640 mid scale
    warped onto a 480x640 target by the identity and by a warp that reaches
    past the source, against warp_grid + F.grid_sample. The grid must agree
    within 1e-6 and the identity's be the linspace grid exactly (+-1 on the
    border, where K8's in-bounds test is a step)."""
    from ransacflow_tpu_torch.kernels.warp_sample import (
        warp_homography, warp_homography_ref, warp_sample_ref)
    from ransacflow_tpu_torch.ops.grid import normalized_grid

    src = torch.rand((1, *TARGET_HW, 3), generator=gen, device="cuda")
    out = {"max_abs_err": 0.0, "grid_max_abs_err": 0.0}
    for warped in (False, True):
        H = torch.eye(3, device="cuda")
        if warped:
            H = torch.tensor([[1.05, 0.02, 0.1], [-0.01, 0.97, -0.05],
                              [0.02, -0.03, 1.0]], device="cuda")
        H = H[None].contiguous()
        img, grid = warp_homography(src, H, TARGET_HW)
        img_r, grid_r = warp_homography_ref(src, H, TARGET_HW)
        torch.cuda.synchronize()
        err, grid_err = (img - img_r).abs().max().item(), (grid - grid_r).abs().max().item()
        # the sampling alone, at the kernel's own grid
        own = (img - warp_sample_ref(src, grid)).abs().max().item()
        require(err <= 1e-5 and grid_err <= 1e-6,
                f"warp_homography (warped {warped}): image err {err} > 1e-5 or grid err "
                f"{grid_err} > 1e-6 (at its own grid {own})")
        if not warped:
            require(torch.equal(grid, normalized_grid(*TARGET_HW, "cuda")[None]),
                    "warp_homography: the identity's grid is not the linspace grid")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["grid_max_abs_err"] = max(out["grid_max_abs_err"], grid_err)
        out["err_at_own_grid" + ("_warp" if warped else "_identity")] = own
    src_nchw = src.permute(0, 3, 1, 2)
    # per pixel: the homography and divide (~12), the weights (~10) and 4
    # taps of 3 channels (a multiply-add each)
    out.update(paired_ms(lambda: warp_homography(src, H, TARGET_HW),
                         lambda: warp_homography_ref(src, H, TARGET_HW)))
    out.update(bound(nbytes(src, H, img, grid), img.numel() // 3 * (22 + 8 * 3)))
    out.update(library(None))
    # a lower yardstick, not the same function: F.grid_sample on the grid
    # built beforehand (no PyTorch call warps by a homography)
    out.update(library(lambda: torch.nn.functional.grid_sample(
        src_nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=True),
        "_grid_sample_prebuilt"))
    return out


def check_head_epilogues(gen):
    """K7: softmax-expectation over (1, 60, 80, 49) logits and the
    matchability sigmoid over (1, 60, 80, 1)."""
    from ransacflow_tpu_torch.kernels.heads import (
        flow_epilogue, flow_epilogue_ref, match_epilogue, match_epilogue_ref)

    flow_logits = 3 * torch.randn((1, 60, 80, 49), generator=gen, device="cuda")
    match_logits = 3 * torch.randn((1, 60, 80, 1), generator=gen, device="cuda")
    got = (flow_epilogue(flow_logits, 7), match_epilogue(match_logits))
    want = (flow_epilogue_ref(flow_logits, 7), match_epilogue_ref(match_logits))
    torch.cuda.synchronize()
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    require(err <= 1e-4, f"head_epilogues: max abs err {err} > 1e-4")
    # per logit: the max, exp, sum and two weighted sums (~7); sigmoid ~4
    return {"max_abs_err": err, **paired_ms(
        lambda: (flow_epilogue(flow_logits, 7), match_epilogue(match_logits)),
        lambda: (flow_epilogue_ref(flow_logits, 7), match_epilogue_ref(match_logits))),
        **bound(nbytes(flow_logits, match_logits, *got),
                7 * flow_logits.numel() + 4 * match_logits.numel()), **library(None)}


def check_compose_tail(gen):
    """K8 at 480x640 from the 60x80 maps, both cycle_match values, grids on
    the border included; matchability is compared off the in-bounds step."""
    from ransacflow_tpu_torch.kernels.compose import compose_tail, compose_tail_ref

    flow8 = 0.04 * torch.randn((1, 60, 80, 2), generator=gen, device="cuda")
    m12 = torch.rand((1, 60, 80, 1), generator=gen, device="cuda")
    m21 = torch.rand((1, 60, 80, 1), generator=gen, device="cuda")
    out = {"max_abs_err": 0.0}
    for warped in (False, True):
        coarse = _homography_grid(*TARGET_HW, warped)
        for cycle in (False, True):
            flow, match = compose_tail(flow8, m12, m21, coarse, cycle)
            flow_r, match_r = compose_tail_ref(flow8, m12, m21, coarse, cycle)
            torch.cuda.synchronize()
            off = ((flow_r.abs() - 1).abs() > 1e-5).all(dim=-1)
            err = max((flow - flow_r).abs().max().item(),
                      (match - match_r)[off].abs().max().item())
            require(err <= 1e-5, f"compose_tail (cycle {cycle}): max abs err {err}")
            out["max_abs_err"] = max(out["max_abs_err"], err)
    for cycle, suffix in ((False, ""), (True, "_cycle")):
        out.update(paired_ms(lambda: compose_tail(flow8, m12, m21, coarse, cycle),
                             lambda: compose_tail_ref(flow8, m12, m21, coarse, cycle),
                             suffix=suffix))
    # per output pixel: three 4-tap upsamplings, the grid sample (~60)
    out.update(bound(nbytes(flow8, m12, m21, coarse, flow, match), 60 * match.numel()))
    out.update(library(None))
    return out


TRAIN_PAIRS, TRAIN_IMG, TRAIN_MARGIN = 16, 224, 88  # the reference's stage presets
TRAIN_FEAT = (2 * TRAIN_PAIRS, TRAIN_IMG // 8, TRAIN_IMG // 8)  # (32, 28, 28)


def _grads(out, inputs, g):
    """Backward of `out` alone (the graph kept), for timing it."""
    return lambda: torch.autograd.grad(out, inputs, g, retain_graph=True)


def _backward_check(name, kernel_fn, plain_fn, inputs, tol, gen):
    """Forward and backward of `kernel_fn` against `plain_fn` on `inputs`
    (each requiring grad): max errors and paired times of the backward.
    Each input's cotangent is held to `tol` times the larger of 1 and the
    plain one's largest magnitude (fp32 rounding grows with the values)."""
    ks = [x.detach().clone().requires_grad_() for x in inputs]
    ps = [x.detach().clone().requires_grad_() for x in inputs]
    out_k, out_p = kernel_fn(*ks), plain_fn(*ps)
    g = torch.randn(out_p.shape, generator=gen, device="cuda")
    d_k = torch.autograd.grad(out_k, ks, g, retain_graph=True)
    d_p = torch.autograd.grad(out_p, ps, g, retain_graph=True)
    torch.cuda.synchronize()
    require(out_k.grad_fn is not None, f"{name}: the kernel's output has no grad_fn")
    errs = [(a - b).abs().max().item() for a, b in zip(d_k, d_p)]
    scales = [max(1.0, b.abs().max().item()) for b in d_p]
    for e, s in zip(errs, scales):
        require(e <= tol * s, f"{name}: backward max abs err {e} > {tol} * {s}")
    return {"max_abs_err": max(errs), "grad_scale": max(scales),
            **paired_ms(_grads(out_k, ks, g), _grads(out_p, ps, g))}


def check_pyramid(gen):
    """K1 on the serving pyramid: 4 sources of 960x1280 into the 7 scales."""
    from ransacflow_tpu_torch.kernels.pyramid import device_pyramid, device_pyramid_ref, taps
    from ransacflow_tpu_torch.utils.image import pyramid_shapes

    shapes = pyramid_shapes()
    src = torch.rand((N_PAIRS, *shapes[0], 3), generator=gen, device="cuda")
    got, want = device_pyramid(src, shapes), device_pyramid_ref(src, shapes)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    # fp32 sums of <= 24 taps per axis, in another order than the matmuls
    require(err <= 1e-5, f"pyramid: max abs err {err} > 1e-5")
    B, H, W, _ = src.shape
    ops = 0  # a multiply-add per nonzero tap: the row pass, then the columns
    for h, w in shapes[1:]:
        ops += 2 * B * 3 * (int(taps(H, h)[1].sum()) * W + h * int(taps(W, w)[1].sum()))
    return {"max_abs_err": err, **paired_ms(lambda: device_pyramid(src, shapes),
                                            lambda: device_pyramid_ref(src, shapes)),
            **bound(nbytes(src, *got[1:]), ops), **library(None)}


def check_blur_pool(gen):
    """K9 at the training stem: (32, 64, 223, 223) in channels-last memory,
    as the feature extractor hands it over; forward and backward."""
    from ransacflow_tpu_torch.kernels.blurpool import binomial_filter, blur_pool, blur_pool_ref

    x = torch.rand((TRAIN_FEAT[0], 64, TRAIN_IMG - 1, TRAIN_IMG - 1), generator=gen,
                   device="cuda").contiguous(memory_format=torch.channels_last)
    filt = binomial_filter(64, 3, "cuda")
    y = blur_pool(x, filt)
    err = (y - blur_pool_ref(x, filt)).abs().max().item()
    require(err <= 1e-6, f"blur_pool: max abs err {err} > 1e-6")  # 9 exact taps
    fwd = {"max_abs_err": err, **paired_ms(lambda: blur_pool(x, filt),
                                           lambda: blur_pool_ref(x, filt)),
           **bound(nbytes(x, y), 18 * y.numel()),
           **library(lambda: torch.nn.functional.conv2d(
               torch.nn.functional.pad(x, (1, 1, 1, 1), mode="reflect"), filt, stride=2,
               groups=64))}
    bwd = _backward_check("blur_pool_bwd", lambda a: blur_pool(a, filt),
                          lambda a: blur_pool_ref(a, filt), [x], 1e-5, gen)
    # the output's cotangent read, the input's written; 9 taps each
    bwd.update(bound(nbytes(y, x), 18 * y.numel()))
    bwd.update(library(None))
    return fwd, bwd


def _upsampled_flow_grid(gen, b2):
    """The identity plus a x8 bilinear upsample (align_corners=True) of a
    random (b2, 28, 28, 2) flow of up to +-3 cells of the 28 x 28 grid,
    clipped to [-1, 1]: the form of the grids net_flow_coarse +
    flow_to_grid hand the training losses, not their values. The flow is
    drawn independently per 8-pixel cell, so the field stretches by up to
    ~6 px per px: smoother than per-pixel noise only at the scale of a cell.
    Phase (f) reads K11's share on the step's own grids."""
    from ransacflow_tpu_torch.models.heads import flow_to_grid
    from ransacflow_tpu_torch.ops.grid import normalized_grid
    from ransacflow_tpu_torch.ops.sampler import upsample_bilinear_x8

    h8 = TRAIN_IMG // 8
    cells = 3 * (2 * torch.rand((b2, h8, h8, 2), generator=gen, device="cuda") - 1)
    flow = upsample_bilinear_x8(cells * (2.0 / h8))
    return flow_to_grid(flow, normalized_grid(TRAIN_IMG, TRAIN_IMG, "cuda")[None]).contiguous()


# K11's three calls in a training step (train/losses.py): the matchability's
# cycle warp (C = 1) and the grid's (C = 2) with both cotangents, the image
# warp (C = 3) with the grid cotangent only
K11_CALLS = (("c1", 1, True), ("c2", 2, True), ("c3", 3, False))


def check_grid_sample_bwd(gen):
    """K11 at the training step's three calls, each on two grids: per-pixel
    noise (identity + 0.05 randn, the worst case for the shared-memory
    splat) and an upsampled random flow's grid. Each: the cotangents against
    the plain version's (1e-5 of the largest magnitude: fp32 atomics in an
    order that changes from run to run), `ms` of torch.autograd.grad
    through the op, `ms_direct` of the bare `grid_sample_backward` (timed
    as the bare aten call of `library_ms` is), the bound and the share of
    splatting tiles that took the shared path, at least 90% on the upsampled
    grid. The row's own keys are C = 2 on the upsampled grid."""
    from ransacflow_tpu_torch.kernels import warp_sample as ws
    from ransacflow_tpu_torch.ops.grid import normalized_grid

    b2 = TRAIN_FEAT[0]
    noise = (normalized_grid(TRAIN_IMG, TRAIN_IMG, "cuda")[None]
             + 0.05 * torch.randn((b2, TRAIN_IMG, TRAIN_IMG, 2), generator=gen,
                                  device="cuda")).clamp(-1, 1).contiguous()
    grids = {"noise": noise, "upsampled": _upsampled_flow_grid(gen, b2)}
    roll = torch.roll(torch.arange(b2, device="cuda"), b2 // 2)
    out = {"max_abs_err": 0.0, "grad_scale": 0.0}
    for grid_name, grid in grids.items():
        images = {1: torch.rand((b2, TRAIN_IMG, TRAIN_IMG, 1), generator=gen, device="cuda"),
                  2: grid[roll].contiguous(),
                  3: torch.rand((b2, TRAIN_IMG, TRAIN_IMG, 3), generator=gen, device="cuda")}
        for call, c, need_image in K11_CALLS:
            suffix = f"_{call}_{grid_name}"
            image = images[c]
            g = torch.randn((*grid.shape[:3], c), generator=gen, device="cuda")
            d_k = ws.grid_sample_backward(image, grid, g, need_image)
            d_p = ws.grid_sample_backward_ref(image, grid, g, need_image)
            torch.cuda.synchronize()
            for name, a, b in zip(("image", "grid"), d_k, d_p):
                if b is None:
                    continue
                err, scale = (a - b).abs().max().item(), max(1.0, b.abs().max().item())
                require(err <= 1e-5 * scale, f"grid_sample_bwd{suffix} ({name}): max abs err "
                                             f"{err} > 1e-5 * {scale}")
                out["max_abs_err"] = max(out["max_abs_err"], err)
                out["grad_scale"] = max(out["grad_scale"], scale)
            ws.reset_tile_counts()
            ws.grid_sample_backward(image, grid, g, need_image)
            shared, glob = ws.tile_counts("cuda").tolist()
            share = out["shared_tile_share" + suffix] = (
                shared / (shared + glob) if need_image else None)
            require(grid_name != "upsampled" or not need_image or share >= 0.9,
                    f"grid_sample_bwd{suffix}: {share} of the tiles shared, < 0.9")
            # autograd through the op, the kernel's and the plain version's
            ks = [image.clone().requires_grad_(need_image), grid.clone().requires_grad_()]
            ps = [image.clone().requires_grad_(need_image), grid.clone().requires_grad_()]
            wanted = lambda xs: xs if need_image else xs[1:]  # noqa: E731
            out_k, out_p = ws.warp_sample(*ks), ws.warp_sample_ref(*ps)
            out.update(paired_ms(_grads(out_k, wanted(ks), g), _grads(out_p, wanted(ps), g),
                                 suffix=suffix))
            direct = lambda: ws.grid_sample_backward(image, grid, g, need_image)  # noqa: E731
            out["ms_direct" + suffix] = cuda_ms(direct)
            out["device_ms_direct" + suffix] = device_ms(direct)
            # read: the cotangent, the grid and the image (once); written:
            # the grid cotangent and, with need_image, the image's; per
            # point and channel the two partials (~10) and the splat (~8)
            n_bytes = nbytes(g, grid, image, grid) + (nbytes(image) if need_image else 0)
            out.update(bound(n_bytes, grid.numel() // 2 * c * (18 if need_image else 10),
                             suffix))
            g_nchw, image_nchw = g.permute(0, 3, 1, 2), image.permute(0, 3, 1, 2)
            out.update(library(lambda: torch.ops.aten.grid_sampler_2d_backward(
                g_nchw, image_nchw, grid, 0, 0, True, [need_image, True]), suffix))
    for key in ("ms", "plain_ms", "device_ms", "plain_device_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms"):
        out[key] = out[key + "_c2_upsampled"]
    return out


def check_correlation_bwd(gen):
    """K6's backward at the training shape (32, 28, 28, 256), k=7."""
    from ransacflow_tpu_torch.kernels.correlation import (
        correlation_volume, correlation_volume_ref)

    x = _normalized((*TRAIN_FEAT, 256), -1, gen)
    y = _normalized((*TRAIN_FEAT, 256), -1, gen)
    out = _backward_check("correlation_volume_bwd", lambda a, b: correlation_volume(a, b, 7),
                          lambda a, b: correlation_volume_ref(a, b, 7), [x, y], 1e-4, gen)
    g_numel = x.numel() // 256 * 49
    # x and y read, the (.., 49) cotangent read, dx and dy written; two
    # multiply-adds per (pixel, offset, channel)
    out.update(bound(nbytes(x, y) * 2 + g_numel * 4, 4 * g_numel * 256))
    out.update(library(None))
    return out


def check_head_epilogues_bwd(gen):
    """K7's backward at the training heads' (32, 28, 28, 49) and (.., 1)."""
    from ransacflow_tpu_torch.kernels.heads import (
        flow_epilogue, flow_epilogue_ref, match_epilogue, match_epilogue_ref)

    flow_logits = 3 * torch.randn((*TRAIN_FEAT, 49), generator=gen, device="cuda")
    match_logits = 3 * torch.randn((*TRAIN_FEAT, 1), generator=gen, device="cuda")
    both = lambda fe, me: lambda a, b: torch.cat(  # noqa: E731
        [fe(a, 7).flatten(), me(b).flatten()])
    out = _backward_check("head_epilogues_bwd", both(flow_epilogue, match_epilogue),
                          both(flow_epilogue_ref, match_epilogue_ref),
                          [flow_logits, match_logits], 1e-5, gen)
    # the logits read and their cotangents written, the outputs' cotangents read
    n_out = flow_logits.numel() // 49 * 2 + match_logits.numel()
    out.update(bound(2 * nbytes(flow_logits, match_logits) + 4 * n_out,
                     10 * (flow_logits.numel() + match_logits.numel())))
    out.update(library(None))
    return out


def check_masked_ssim(gen):
    """K10 at the training shape: (32, 224, 224, 3), the mask from a
    matchability that is zero outside the 48x48 supervised centre."""
    from ransacflow_tpu_torch.kernels.ssim import masked_ssim_loss, masked_ssim_loss_ref

    b2 = TRAIN_FEAT[0]
    img1 = torch.rand((b2, TRAIN_IMG, TRAIN_IMG, 3), generator=gen, device="cuda")
    img2 = (img1 + 0.1 * torch.rand(img1.shape, generator=gen, device="cuda")).clamp(0, 1)
    match = torch.zeros((b2, TRAIN_IMG, TRAIN_IMG, 1), device="cuda")
    c = slice(TRAIN_MARGIN, TRAIN_IMG - TRAIN_MARGIN)
    match[:, c, c] = torch.rand(match[:, c, c].shape, generator=gen, device="cuda")
    loss, ref = masked_ssim_loss(img1, img2, match), masked_ssim_loss_ref(img1, img2, match)
    rel = abs(loss.item() - ref.item()) / abs(ref.item())
    require(rel <= 1e-5, f"masked_ssim: relative err {rel} > 1e-5")
    require(loss.item() == masked_ssim_loss(img1, img2, match).item(),
            "masked_ssim: two calls differ (the reduction must be deterministic)")
    # per pixel and channel: five separable 11-tap blurs (220) and the SSIM
    # map (~25); per pixel the separable box of the mask (44)
    fwd = {"max_abs_err": abs(loss.item() - ref.item()), "rel_err": rel,
           **paired_ms(lambda: masked_ssim_loss(img1, img2, match),
                       lambda: masked_ssim_loss_ref(img1, img2, match)),
           **bound(nbytes(img1, img2, match, loss), 245 * img1.numel() + 44 * match.numel()),
           **library(None)}
    i_k, i_p = img1.clone().requires_grad_(), img1.clone().requires_grad_()
    l_k = masked_ssim_loss(i_k, img2, match)
    l_p = masked_ssim_loss_ref(i_p, img2, match)
    one = torch.ones((), device="cuda")
    d_k = torch.autograd.grad(l_k, i_k, one, retain_graph=True)[0]
    d_p = torch.autograd.grad(l_p, i_p, one, retain_graph=True)[0]
    scale = d_p.abs().max().item()
    err = (d_k - d_p).abs().max().item()
    require(err <= 1e-4 * scale, f"masked_ssim_bwd: max abs err {err} > 1e-4 * {scale}")
    # the forward's maps, three partials blurred again (132) and the sum (~15)
    bwd = {"max_abs_err": err, "grad_scale": scale,
           **paired_ms(_grads(l_k, i_k, one), _grads(l_p, i_p, one)),
           **bound(nbytes(img1, img2, match, d_k), 392 * img1.numel() + 44 * match.numel()),
           **library(None)}
    return fwd, bwd


SERVING_RESAMPLES = (((60, 80), (50, 66)), ((30, 40), (40, 53)), ((30, 40), (25, 33)),
                     ((15, 20), (20, 26)))  # a serving pair's K12 calls at stride 3


def check_anchor_resample(gen):
    """K12 at a serving pair's four resamples (anchors 0, 3, 6 of the 7-scale
    pyramid), 1024 channels; the rows written into one bank as the path does."""
    import torch.nn.functional as F

    from ransacflow_tpu_torch.kernels.anchor_resample import (
        anchor_resample_feats, anchor_resample_feats_ref, bilinear_weights)
    from ransacflow_tpu_torch.kernels.pyramid import taps

    maps = [3 * torch.randn((1, h, w, N_CHANNELS), generator=gen, device="cuda")
            for (h, w), _ in SERVING_RESAMPLES]
    sizes = [fh * fw for _, (fh, fw) in SERVING_RESAMPLES]
    bank = torch.empty((sum(sizes), N_CHANNELS), device="cuda")

    def kernel():
        offset = 0
        for fmap, (_, (fh, fw)), n in zip(maps, SERVING_RESAMPLES, sizes):
            anchor_resample_feats(fmap, fh, fw, out=bank[offset:offset + n])
            offset += n
        return bank

    def plain():
        return torch.cat([anchor_resample_feats_ref(fmap, fh, fw)
                          for fmap, (_, (fh, fw)) in zip(maps, SERVING_RESAMPLES)])

    def lib():  # F.interpolate agrees with JAX's resize (tests/test_torch_fastmodes.py)
        return [F.normalize(F.interpolate(fmap.permute(0, 3, 1, 2), size=(fh, fw),
                                          mode="bilinear", align_corners=False,
                                          antialias=True), dim=1)
                for fmap, (_, (fh, fw)) in zip(maps, SERVING_RESAMPLES)]

    err = (kernel() - plain()).abs().max().item()
    torch.cuda.synchronize()
    # unit rows from fp32 sums of <= 9 taps in another order
    require(err <= 1e-5, f"anchor_resample: max abs err {err} > 1e-5")
    ops = 0  # a multiply-add per tap and channel, and the normalization
    for (h, w), (fh, fw) in SERVING_RESAMPLES:
        n_taps = (int(taps(h, fh, bilinear_weights)[1].sum())
                  * int(taps(w, fw, bilinear_weights)[1].sum()))
        ops += N_CHANNELS * (2 * n_taps + 3 * fh * fw)
    return {"max_abs_err": err, **paired_ms(kernel, plain),
            **bound(nbytes(*maps, bank), ops), **library(lib)}


def check_ppm_pool(gen):
    """K13 at the sky mask's conv5 shapes: (1, 47, 63, 2048) for a 480x640
    image at the capped scales, (1, 38, 50, 2048) at the short side 300."""
    import torch.nn.functional as F

    from ransacflow_tpu_torch.kernels.adaptive_pool import bin_edges, ppm_pool, ppm_pool_ref

    scales = (1, 2, 3, 6)
    out = {"max_abs_err": 0.0}
    for (h, w), suffix in (((47, 63), ""), ((38, 50), "_short300")):
        x = torch.relu(torch.randn((1, h, w, 2048), generator=gen, device="cuda"))
        got, want = ppm_pool(x, scales), ppm_pool_ref(x, scales)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        # fp32 means of up to 2961 values summed in another order
        require(err <= 1e-5, f"ppm_pool: max abs err {err} > 1e-5")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        x_nchw = x.permute(0, 3, 1, 2)
        adds = sum((r1 - r0) * (c1 - c0) for s in scales for r0, r1 in bin_edges(h, s)
                   for c0, c1 in bin_edges(w, s))
        out.update(paired_ms(lambda: ppm_pool(x, scales), lambda: ppm_pool_ref(x, scales),
                             suffix=suffix))
        out.update(bound(nbytes(x, *got), adds * 2048, suffix))
        out.update(library(lambda: [F.adaptive_avg_pool2d(x_nchw, s) for s in scales],
                           suffix))
    return out


def phase_kernels():
    """Each kernel's check, its line printed as soon as it passes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = ((("lanczos_pyramid",), check_pyramid),
              (("correlation_volume",), check_correlation),
              (("mutual_argmax",), check_matching),
              (("ransac_score",), check_ransac),
              (("ransac_adaptive",), check_ransac_adaptive),
              (("warp_sample",), check_warp_sample),
              (("warp_homography",), check_warp_homography),
              (("head_epilogues",), check_head_epilogues),
              (("compose_tail",), check_compose_tail),
              (("blur_pool", "blur_pool_bwd"), check_blur_pool),
              (("masked_ssim", "masked_ssim_bwd"), check_masked_ssim),
              (("grid_sample_bwd",), check_grid_sample_bwd),
              (("correlation_volume_bwd",), check_correlation_bwd),
              (("head_epilogues_bwd",), check_head_epilogues_bwd),
              (("anchor_resample",), check_anchor_resample),
              (("ppm_pool",), check_ppm_pool))
    results = {}
    for names, check in checks:
        got = check(gen)
        for name, r in zip(names, got if len(names) > 1 else (got,)):
            results[name] = r
            print(f"(c) {name}: " + ", ".join(f"{k}={v}" for k, v in r.items()), flush=True)
    return results


def _blocky(rng, n, h, w):
    base = (rng.rand(n, h // 4, w // 4, 3) > 0.5).astype(np.float32)
    return np.kron(base, np.ones((1, 4, 4, 1), np.float32))[:, :h, :w]


def _nets(device):
    from ransacflow_tpu_torch.models.convert import init_resnet50_layer3
    from ransacflow_tpu_torch.pipeline import init_alignment_params

    return (init_resnet50_layer3(torch.Generator().manual_seed(0), device),
            init_alignment_params(torch.Generator().manual_seed(1), device))


SMALL_SHAPES = ((128, 128), (64, 64), (32, 32))
# 5 scales for the anchor mode at stride 3: anchors 0 and 3, the target's
# own 64x64 (seeded trunks are not smooth across scales, and a target
# between anchors fits no sane homography on 16 cells), and only
# downscales beside the two identities: an upscale's edge cells copy the
# anchor's, and those copies tie exactly with the target's own rows. The
# full-width serving run below takes the upscales.
SMALL_ANCHOR_SHAPES = ((128, 128), (112, 112), (96, 96), (64, 64), (48, 48))


def check_small_pair_against_cpu(shapes=SMALL_SHAPES, target_scale=None, **mode):
    """The port on the card against its plain CPU path (held against the JAX
    package by tests/test_torch_pipeline.py and, in the fast modes,
    tests/test_torch_fastmodes.py), one 64x64 target, same draws. The target
    is a blocky image of its own, or the source's scale `target_scale`.
    `mode`: fused_align's anchor_stride / relax_cells. The coarse matches
    (m1, m2, valid) must be identical."""
    from ransacflow_tpu_torch.pipeline.fused import _coarse_match, device_pyramid, fused_align

    rng = np.random.RandomState(3)
    src = torch.from_numpy(_blocky(rng, 1, *shapes[0]))
    tgt = torch.from_numpy(_blocky(rng, 1, 64, 64))
    samples = torch.from_numpy(rng.randint(0, 16, (256, 4)).astype(np.int32))
    outs, matches = {}, {}
    for device in ("cpu", "cuda"):
        resnet, align = _nets(device)
        pyr = device_pyramid(src.to(device), list(shapes))
        target = tgt.to(device) if target_scale is None else pyr[target_scale]
        outs[device] = fused_align(resnet, align, pyr, target, n_iter=256,
                                   injected_samples=samples.to(device), **mode)
        with torch.inference_mode():
            matches[device] = [m.cpu() for m in _coarse_match(resnet, pyr, target, **mode)]
    (m1c, m2c, vc), (m1g, m2g, vg) = matches["cpu"], matches["cuda"]
    require(torch.equal(vc, vg) and torch.equal(m1c[vc], m1g[vg]) and torch.equal(m2c, m2g),
            f"small pair {mode}: coarse matches differ from CPU "
            f"({int(vc.sum())} vs {int(vg.sum())} valid)")
    cpu, gpu = outs["cpu"], {k: v.cpu() for k, v in outs["cuda"].items()}
    require(bool(gpu["found"] == cpu["found"]), "small pair: found differs from CPU")
    require(int(gpu["num_inliers"]) == int(cpu["num_inliers"]),
            f"small pair: num_inliers {int(gpu['num_inliers'])} vs CPU "
            f"{int(cpu['num_inliers'])}")
    # The in-bounds mask is a step at |flow| = 1, and the warped grid lands
    # exactly on the border there: a 1e-7 difference flips such a pixel, so
    # matchability is compared off the border.
    border = ((cpu["flow"].abs() - 1).abs() < 1e-5).any(dim=-1)[0]
    errs = {k: (gpu[k].float() - cpu[k].float()).abs().max().item()
            for k in ("H21", "flow")}
    errs["match"] = (gpu["match"] - cpu["match"])[~border].abs().max().item()
    errs["border_px"] = int(border.sum())
    errs["valid_matches"] = int(vc.sum())
    # cuDNN and CPU convolutions sum in other orders (fp32, TF32 off)
    require(errs["H21"] <= 1e-4 and errs["flow"] <= 1e-3 and errs["match"] <= 1e-3,
            f"small pair: differs from CPU: {errs}")
    return errs


def _launches_of(fn):
    """fn() with every launch count set to 0 just before it and read just
    after: the launches of that one path. Returns (fn(), counts)."""
    from ransacflow_tpu_torch import kernels

    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launch_counts()


def _require_launched(path, launches, names=(), exact=None):
    """Each kernel of `names` launched on `path`, and each of `exact` the
    given number of times."""
    missing = [k for k in names if launches[k] == 0]
    require(not missing, f"{path}: kernel not launched: {missing}; {launches}")
    for k, n in (exact or {}).items():
        require(launches[k] == n, f"{path}: {k} launched {launches[k]} times, "
                                  f"expected {n}; {launches}")


def _fine_warps(launches, grid_form=0):
    """The warp counts an alignment path must show: one warp_homography per
    fine pass (one per compose_tail launch), and `grid_form` warp_sample."""
    return {"warp_homography": launches["compose_tail"], "warp_sample": grid_form}


def phase_serving(card):
    from ransacflow_tpu_torch.pipeline.fused import device_pyramid, fused_align_batch
    from ransacflow_tpu_torch.utils.image import pyramid_shapes

    small = check_small_pair_against_cpu()
    print(f"(d) small pair, card vs CPU max abs err: {small}", flush=True)

    shapes = pyramid_shapes()
    rng = np.random.RandomState(0)
    sources = torch.from_numpy(_blocky(rng, N_PAIRS, *shapes[0])).cuda()
    targets = torch.from_numpy(_blocky(rng, N_PAIRS, *TARGET_HW)).cuda()[:, None]
    resnet, align = _nets("cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)

    def serve():
        pyramids = tuple(p[:, None] for p in device_pyramid(sources, shapes))
        return fused_align_batch(resnet, align, pyramids, targets, gen,
                                 n_iter=N_ITER)

    out, launches = _launches_of(serve)
    _require_launched("serving path", launches, SERVING_KERNELS,
                      {"lanczos_pyramid": 1, "ransac_adaptive": 0, "anchor_resample": 0,
                       "compose_tail": N_PAIRS, **_fine_warps(launches)})
    ht, wt = TARGET_HW
    require(tuple(out["H21"].shape) == (N_PAIRS, 3, 3), "H21 shape")
    require(tuple(out["flow"].shape) == (N_PAIRS, 1, ht, wt, 2), "flow shape")
    require(tuple(out["match"].shape) == (N_PAIRS, ht, wt), "match shape")
    for key in ("H21", "flow", "match", "flow_down8", "match_down8"):
        require(bool(torch.isfinite(out[key]).all()), f"{key} is not finite")

    best_ms = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        serve()
        end.record()
        end.synchronize()
        best_ms = min(best_ms, start.elapsed_time(end))
    pairs_s = N_PAIRS / (best_ms / 1e3)
    print(f"(d) serving path: {N_PAIRS} pairs, launches {launches}, found "
          f"{out['found'].tolist()}, inliers {out['num_inliers'].tolist()}, "
          f"best of 3: {best_ms:.1f} ms = {pairs_s:.3f} pairs/s "
          f"(fp32, scan, n_iter {N_ITER}) on {card}", flush=True)
    return launches, pairs_s


def _related_pairs(rng, n, src_hw):
    """bench.py:102-112: a 2x nearest-upsampled blocky source whose mid
    scale is the target before a (16, 16) roll."""
    bases = _blocky(rng, n, *TARGET_HW)
    srcs = np.kron(bases, np.ones((1, 2, 2, 1), np.float32))[:, :src_hw[0], :src_hw[1]]
    return srcs, np.roll(bases, (16, 16), axis=(1, 2))


def _h_error(h_a, h_b, n=64):
    """Mean distance between the maps of two homographies on random points."""
    pts = np.random.RandomState(0).rand(n, 2) * 1.2 - 0.6
    p = np.concatenate([pts, np.ones((n, 1))], 1)
    qa, qb = p @ np.asarray(h_a, np.float64).T, p @ np.asarray(h_b, np.float64).T
    return np.abs(qa[:, :2] / qa[:, 2:] - qb[:, :2] / qb[:, 2:]).mean()


@torch.inference_mode()
def _slot_stages_ms(align, bank, featt, src_idx, valid, coords_a, coords_b, src,
                    featt_fine, adaptive_chunk, reps=5):
    """Median device time of each stage of one slot of the loop (pair 0, an
    empty mask), from CUDA events recorded around the stages. The warp is
    timed both ways in turns (which goes first alternates): 'warp_old' the
    grid built by warp_grid and sampled by K5's grid form, 'warp' K5's
    homography form, whose image and grid the later stages take."""
    from ransacflow_tpu_torch.kernels.compose import compose_tail
    from ransacflow_tpu_torch.kernels.correlation import correlation_volume
    from ransacflow_tpu_torch.kernels.warp_sample import warp_homography, warp_sample
    from ransacflow_tpu_torch.models.feature_extractor import feature_extractor
    from ransacflow_tpu_torch.models.heads import net_flow_coarse, net_matchability
    from ransacflow_tpu_torch.models.layers import l2_normalize
    from ransacflow_tpu_torch.ops.homography import warp_grid
    from ransacflow_tpu_torch.ops.ransac import ransac_homography, ransac_homography_adaptive
    from ransacflow_tpu_torch.pipeline.coarse import (
        _homogeneous_matches, _mask_to_cells, _match_masked)

    ht, wt = TARGET_HW
    gen = torch.Generator(device="cuda").manual_seed(0)
    samples = []
    for rep in range(reps + 1):  # the first is a warm-up
        marks = {}

        def stage(name, fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            result = fn()
            end.record()
            marks[name] = (start, end)
            return result

        def matches():
            cells = _mask_to_cells(torch.zeros((ht, wt), device="cuda"), ht // 16, wt // 16)
            idx, ok = _match_masked(bank, featt, cells, src_idx, valid, False)
            return (*_homogeneous_matches(coords_a, coords_b, idx), ok)

        m1, m2, ok = stage("mask_and_matches", matches)
        if adaptive_chunk:
            res, _ = stage("ransac", lambda: ransac_homography_adaptive(
                m1, m2, ok, 0.05, MH_N_ITER, adaptive_chunk, generator=gen))
        else:
            res = stage("ransac", lambda: ransac_homography(m1, m2, ok, 0.05, MH_N_ITER,
                                                            generator=gen))
        warps = [("warp_old", lambda: warp_sample(src, warp_grid(res.H21[None], ht, wt))),
                 ("warp", lambda: warp_homography(src, res.H21[None], (ht, wt)))]
        for name, fn in (warps if rep % 2 else warps[::-1]):
            got = stage(name, fn)
            if name == "warp":
                src_warp, grid = got
        feats = stage("fine_features", lambda: l2_normalize(
            feature_extractor(align["netFeatCoarse"], src_warp)))
        corr12, corr21 = stage("correlation", lambda: (
            correlation_volume(featt_fine, feats, 7), correlation_volume(feats, featt_fine, 7)))
        flow8, m12, m21 = stage("heads", lambda: (
            net_flow_coarse(align["netFlowCoarse"], corr12, up8=False),
            net_matchability(align["netMatch"], corr12, up8=False),
            net_matchability(align["netMatch"], corr21, up8=False)))
        stage("compose", lambda: compose_tail(flow8, m12, m21, grid, False))
        torch.cuda.synchronize()
        samples.append({name: a.elapsed_time(b) for name, (a, b) in marks.items()})
    return {name: float(np.median([smp[name] for smp in samples[1:]])) for name in samples[0]}


def phase_multihomo(card):
    from PIL import Image

    from ransacflow_tpu_torch.models.convert import (
        alignment_params_from_tree, init_resnet50_layer3, load_params_npz)
    from ransacflow_tpu_torch.ops.grid import feature_cell_coords
    from ransacflow_tpu_torch.ops.matching import mutual_matching
    from ransacflow_tpu_torch.pipeline import (
        CoarseAligner, multi_homography_predict, multi_homography_predict_fused)
    from ransacflow_tpu_torch.pipeline.coarse import _coarse_feats
    from ransacflow_tpu_torch.pipeline.fine import fine_features
    from ransacflow_tpu_torch.pipeline.bank import bank_coords
    from ransacflow_tpu_torch.pipeline.fused import device_pyramid
    from ransacflow_tpu_torch.pipeline.multihomo import _fused_multi_homo_batch
    from ransacflow_tpu_torch.utils.image import pyramid_shapes

    t0 = time.perf_counter()
    shapes = pyramid_shapes()
    ht, wt = TARGET_HW
    srcs_np, tgts_np = _related_pairs(np.random.RandomState(1), N_PAIRS, shapes[0])
    sources = torch.from_numpy(srcs_np).cuda()[:, None]
    targets = torch.from_numpy(tgts_np).cuda()[:, None]
    resnet = init_resnet50_layer3(torch.Generator().manual_seed(0), "cuda")
    align = alignment_params_from_tree(load_params_npz(ACCEPT_WEIGHTS), "cuda")
    bgs = torch.ones((N_PAIRS, ht, wt), device="cuda")
    fh, fw = ht // 16, wt // 16
    y, x = feature_cell_coords(fh, fw, "cuda")
    coords_a, coords_b = bank_coords(shapes, "cuda"), torch.stack([x, y], dim=1)

    @torch.inference_mode()
    def setup(source, target):
        pyr = device_pyramid(source, shapes)
        bank = torch.cat([_coarse_feats(resnet, im) for im in pyr])
        featt = _coarse_feats(resnet, target)
        m = mutual_matching(bank.T, featt.T)
        return (bank, featt, m.src_idx, m.valid, pyr[len(shapes) // 2],
                fine_features(align, target))

    @torch.inference_mode()
    def run(adaptive_chunk):
        banks, featts, src_idx, valids, mids, ffines = (
            torch.stack(z) for z in zip(*map(setup, sources, targets)))
        gens = [torch.Generator(device="cuda").manual_seed(MH_SEED + k)
                for k in range(N_PAIRS)]
        return _fused_multi_homo_batch(
            align, banks, featts, coords_a, coords_b, src_idx, valids, mids, ffines,
            bgs, gens, 0.05, 0.01, feat_h=fh, feat_w=fw, max_coarse=MH_MAX_COARSE,
            cycle_match=False, kernel_size=7, n_iter=MH_N_ITER, rematch=False,
            adaptive_chunk=adaptive_chunk)

    series = {"adaptive": MH_CHUNK, "fixed": 0}
    outs, launches = {}, {}
    for name, chunk in series.items():
        outs[name], launches[f"multihomo_{name}"] = _launches_of(lambda: run(chunk))
    no_k3 = tuple(k for k in MULTIHOMO_KERNELS if k != "ransac_score")
    _require_launched("multi-homography loop, adaptive", launches["multihomo_adaptive"],
                      no_k3, {"ransac_score": 0, **_fine_warps(launches["multihomo_adaptive"])})
    _require_launched("multi-homography loop, fixed", launches["multihomo_fixed"],
                      SERVING_KERNELS, {"ransac_adaptive": 0,
                                        **_fine_warps(launches["multihomo_fixed"])})
    for name, out in outs.items():  # one warp per slot run: a slot run evaluated > 0
        slots = int((out["n_evaluated"] > 0).sum())
        require(launches[f"multihomo_{name}"]["warp_homography"] == slots,
                f"{name}: warp_homography launched "
                f"{launches[f'multihomo_{name}']['warp_homography']} times for {slots} slots")
    n_slots = MH_MAX_COARSE + 1
    readings = {}
    for name, out in outs.items():
        require(tuple(out["hs"].shape) == (N_PAIRS, n_slots, 3, 3), f"{name}: hs shape")
        for key in ("flows", "matches"):
            require(tuple(out[key].shape) == (N_PAIRS, n_slots, ht // 8, wt // 8, 2),
                    f"{name}: {key} shape")
        for key in ("hs", "flows", "matches"):
            require(bool(torch.isfinite(out[key]).all()), f"{name}: {key} is not finite")
        counts = out["count"].tolist()
        require(all(1 <= c <= n_slots for c in counts), f"{name}: counts {counts}")
        best_ms = float("inf")
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(series[name])
            end.record()
            end.synchronize()
            best_ms = min(best_ms, start.elapsed_time(end))
        fits = [[n for n in row if n > 0] for row in out["n_evaluated"].tolist()]
        readings[name] = {"pairs_s": N_PAIRS / (best_ms / 1e3), "best_ms": best_ms,
                          "counts": counts, "avg_homographies": float(np.mean(counts)),
                          "n_evaluated_per_fit": fits}
        print(f"(e) {name} RANSAC (cap {MH_N_ITER}"
              f"{f', blocks of {MH_CHUNK}' if series[name] else ''}): "
              f"best of 3: {best_ms:.1f} ms = {readings[name]['pairs_s']:.3f} pairs/s, "
              f"homographies {counts} (avg {readings[name]['avg_homographies']}), "
              f"hypotheses per fit {fits} on {card}", flush=True)
    print(f"(e) launches by series: {launches}", flush=True)
    bank, featt, src_idx, valid, mid, ffine = setup(sources[0], targets[0])
    for name, chunk in series.items():
        stages = _slot_stages_ms(align, bank, featt, src_idx, valid, coords_a,
                                 coords_b, mid, ffine, chunk)
        readings[name]["slot_stage_ms"] = stages
        print(f"(e) one slot, {name} RANSAC, stage ms (median of 5): {stages}", flush=True)

    # The host loop on pair 0, from PIL images at min_size 480, and the
    # device-resident loop on the same aligner and the same seed: both draw
    # the same minimal sets, so their first homographies differ only by the
    # host's fp64 polish. (Fits from other matches or draws differ by RANSAC's
    # own scatter, ~0.01 at tolerance 0.05 on these pairs; printed, not held.)
    to_pil = lambda a: Image.fromarray((a * 255).round().astype(np.uint8))  # noqa: E731
    aligner = CoarseAligner(resnet, "cuda", nb_scale=7, n_iter=MH_N_ITER, min_size=480,
                            seed=MH_SEED)
    aligner.set_pair(to_pil(srcs_np[0]), to_pil(tgts_np[0]))
    kw = dict(max_coarse=MH_MAX_COARSE, mask_region_th=0.01, cycle_match=False)
    host = multi_homography_predict(aligner, align, **kw)
    fused = multi_homography_predict_fused(
        aligner, align, generator=torch.Generator(device="cuda").manual_seed(MH_SEED), **kw)
    require(host is not None and fused is not None, "host or fused loop found nothing")
    gap = _h_error(host["coarse_h"][0], fused["coarse_h"][0])
    require(gap < 0.01, f"host loop's first H is {gap} from the device loop's")
    batch_gap = _h_error(host["coarse_h"][0], outs["fixed"]["hs"][0, 0].cpu().numpy())
    seconds = time.perf_counter() - t0
    print(f"(e) pair 0 from PIL: host loop {host['coarse_h'].shape[0]} homographies, "
          f"device loop {fused['coarse_h'].shape[0]}; first H {gap:.2e} apart "
          f"(same draws), {batch_gap:.2e} from the batch run's (device pyramid, "
          f"other draws); phase (e) {seconds:.1f} s", flush=True)
    return launches, readings

ANCHOR = dict(anchor_stride=3, relax_cells=1)  # bench.py's anchor serving series
FAST_KERNELS = SERVING_KERNELS + ("anchor_resample", "ransac_adaptive")
# the loop from PIL images: no device pyramid (K1), adaptive RANSAC (no K3)
SKY_KERNELS = ("ppm_pool", "mutual_argmax", "ransac_adaptive", "warp_homography",
               "correlation_volume", "head_epilogues", "compose_tail", "blur_pool")


def _to_pil(a):
    from PIL import Image

    return Image.fromarray((a * 255).round().astype(np.uint8))


def _event_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _align_cli(tmp, src, tgt):
    """`python -m ransacflow_tpu_torch.cli.align ... --device cuda` in the
    fast modes on two PNGs; its outputs must exist."""
    paths = [f"{tmp}/a.png", f"{tmp}/b.png"]
    for img, path in zip((src, tgt), paths):
        img.save(path)
    cmd = [sys.executable, "-m", "ransacflow_tpu_torch.cli.align", "--img1", paths[0],
           "--img2", paths[1], "--outdir", f"{tmp}/out", "--device", "cuda",
           "--anchorStride", "3", "--relaxCells", "1", "--adaptiveChunk", str(MH_CHUNK)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0, f"cli.align exited {proc.returncode}:\n"
                                  f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    names = ("fine_aligned_source.png", "resized_target.png", "comb_coarse_alignment.png",
             "comb_fine_alignment.png", "H21.npy")
    require(all(os.path.exists(f"{tmp}/out/{n}") for n in names),
            f"cli.align: outputs missing: {os.listdir(f'{tmp}/out')}")
    return {"seconds": seconds, "H21": np.load(f"{tmp}/out/H21.npy").tolist()}


def phase_fast_modes(card, exact_pairs_s):
    """(g) The opt-in fast modes through the public entry points: a small
    pair against the CPU, the serving batch of (d) at anchor stride 3 with
    relax_cells 1 (fixed 10k and adaptive), `RansacFlowAligner.align_images`,
    `cli.align`, and the device multi-homography loop with relax_cells
    against the host loop. Each path's launches are counted on their own."""
    import tempfile

    from ransacflow_tpu_torch.models.convert import alignment_params_from_tree, load_params_npz
    from ransacflow_tpu_torch.pipeline import (
        CoarseAligner, RansacFlowAligner, multi_homography_predict,
        multi_homography_predict_fused)
    from ransacflow_tpu_torch.pipeline.fused import device_pyramid, fused_align_batch
    from ransacflow_tpu_torch.utils.image import pyramid_shapes

    t0 = time.perf_counter()
    small = check_small_pair_against_cpu(SMALL_ANCHOR_SHAPES, 3, **ANCHOR)
    print(f"(g) small pair, anchor 3 + relax 1, card vs CPU (coarse matches identical), "
          f"max abs err: {small}", flush=True)
    shapes = pyramid_shapes()
    n_scales = len(shapes)
    rng = np.random.RandomState(0)  # the pairs of (d)
    sources = torch.from_numpy(_blocky(rng, N_PAIRS, *shapes[0])).cuda()
    targets = torch.from_numpy(_blocky(rng, N_PAIRS, *TARGET_HW)).cuda()[:, None]
    resnet, align = _nets("cuda")
    align_mh = alignment_params_from_tree(load_params_npz(ACCEPT_WEIGHTS), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    series = {"exact": {}, "anchor3_relax1": ANCHOR,
              "anchor3_relax1_adaptive4096": dict(ANCHOR, adaptive_chunk=MH_CHUNK)}

    def serve(kw):
        pyramids = tuple(p[:, None] for p in device_pyramid(sources, shapes))
        return fused_align_batch(resnet, align, pyramids, targets, gen, n_iter=N_ITER, **kw)

    # every scale of every pair is one K12 launch (an identity one at an anchor)
    per_batch = {"anchor_resample": n_scales * N_PAIRS, "lanczos_pyramid": 1,
                 "compose_tail": N_PAIRS}
    launches, outs = {}, {}
    outs["anchor3_relax1"], launches["fast_serving_fixed"] = _launches_of(
        lambda: serve(series["anchor3_relax1"]))
    _require_launched("fast serving, fixed", launches["fast_serving_fixed"],
                      SERVING_KERNELS, dict(per_batch, ransac_adaptive=0))
    _require_launched("fast serving, fixed", launches["fast_serving_fixed"],
                      exact=_fine_warps(launches["fast_serving_fixed"]))
    outs["anchor3_relax1_adaptive4096"], launches["fast_serving_adaptive"] = _launches_of(
        lambda: serve(series["anchor3_relax1_adaptive4096"]))
    _require_launched("fast serving, adaptive", launches["fast_serving_adaptive"],
                      [k for k in FAST_KERNELS if k != "ransac_score"],
                      dict(per_batch, ransac_score=0,
                           **_fine_warps(launches["fast_serving_adaptive"])))

    for name, out in outs.items():
        require(tuple(out["H21"].shape) == (N_PAIRS, 3, 3), f"{name}: H21 shape")
        for key in ("H21", "flow", "match", "flow_down8", "match_down8"):
            require(bool(torch.isfinite(out[key]).all()), f"{name}: {key} is not finite")
    best = {name: float("inf") for name in series}
    for _ in range(3):  # in turns, in one call
        for name, kw_ in series.items():
            best[name] = min(best[name], _event_ms(lambda: serve(kw_)))
    readings = {name: {"best_ms": ms, "pairs_s": N_PAIRS / (ms / 1e3)}
                for name, ms in best.items()}
    for name, out in outs.items():
        readings[name].update(found=out["found"].tolist(),
                              inliers=out["num_inliers"].tolist())
    ratio = readings["anchor3_relax1"]["pairs_s"] / readings["exact"]["pairs_s"]
    print(f"(g) serving batch, {N_PAIRS} pairs, best of 3 in turns: "
          + ", ".join(f"{n} {r['pairs_s']:.3f} pairs/s" for n, r in readings.items())
          + f"; anchor/exact {ratio:.3f}; (d) exact {exact_pairs_s:.3f} pairs/s; "
          f"found/inliers {[(n, outs[n]['num_inliers'].tolist()) for n in outs]}; launches "
          f"fixed {launches['fast_serving_fixed']}, adaptive "
          f"{launches['fast_serving_adaptive']} on {card}", flush=True)

    base = _blocky(np.random.RandomState(8), 1, *TARGET_HW)[0]
    src_img, tgt_img = _to_pil(base), _to_pil(np.roll(base, (16, 16), axis=(0, 1)))
    aligner = RansacFlowAligner(align, resnet, "cuda", adaptive_chunk=MH_CHUNK, **ANCHOR)
    api, launches["align_images"] = _launches_of(lambda: aligner.align_images(src_img, tgt_img))
    _require_launched("align_images", launches["align_images"],
                      ("mutual_argmax", "ransac_adaptive", "warp_homography",
                       "correlation_volume", "head_epilogues", "compose_tail", "blur_pool"),
                      {"anchor_resample": n_scales, "ransac_score": 0, "lanczos_pyramid": 0,
                       # warped_fine is the one grid-form warp
                       **_fine_warps(launches["align_images"], grid_form=1)})
    require(api["H21"] is not None, "align_images found no homography")
    for key in ("flow", "match", "warped_coarse", "warped_fine"):
        require(bool(np.isfinite(api[key]).all()), f"align_images: {key} is not finite")
    ht, wt = api["target"].shape[:2]
    require(api["flow"].shape == (ht, wt, 2) and api["warped_fine"].shape == (ht, wt, 3),
            "align_images: shapes")
    t1 = time.perf_counter()
    aligner.align_images(src_img, tgt_img)
    api_ms = (time.perf_counter() - t1) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        cli = _align_cli(tmp, src_img, tgt_img)
    print(f"(g) align_images (quick-start defaults, anchor 3, relax 1, adaptive "
          f"{MH_CHUNK}) on a 480x640 pair: target {ht}x{wt}, H21 {api['H21'].tolist()}, "
          f"{api_ms:.1f} ms (host clock, a second call), launches "
          f"{launches['align_images']}; cli.align rc 0 in {cli['seconds']:.1f} s, "
          f"H21 {cli['H21']}", flush=True)

    srcs_np, tgts_np = _related_pairs(np.random.RandomState(1), 1, shapes[0])  # (e)'s pair 0
    coarse = CoarseAligner(resnet, "cuda", nb_scale=7, n_iter=MH_N_ITER, min_size=480,
                           seed=MH_SEED, rematch_per_call=True, **ANCHOR)
    kw = dict(max_coarse=MH_MAX_COARSE, mask_region_th=0.01, cycle_match=False)
    loop_kernels = ("mutual_argmax", "ransac_score", "warp_homography", "correlation_volume",
                    "head_epilogues", "compose_tail", "blur_pool")
    _, launches["loop_set_pair_anchor"] = _launches_of(
        lambda: coarse.set_pair(_to_pil(srcs_np[0]), _to_pil(tgts_np[0])))
    _require_launched("set_pair, anchor mode", launches["loop_set_pair_anchor"],
                      exact={"anchor_resample": 7, "mutual_argmax": 0})  # rematch: none cached
    host, launches["loop_relax1_host"] = _launches_of(
        lambda: multi_homography_predict(coarse, align_mh, **kw))
    _require_launched("host loop, relax 1", launches["loop_relax1_host"], loop_kernels,
                      {"anchor_resample": 0, "ransac_adaptive": 0,
                       **_fine_warps(launches["loop_relax1_host"])})
    fused, launches["loop_relax1_device"] = _launches_of(
        lambda: multi_homography_predict_fused(
            coarse, align_mh, generator=torch.Generator(device="cuda").manual_seed(MH_SEED),
            **kw))
    _require_launched("device loop, relax 1", launches["loop_relax1_device"], loop_kernels,
                      {"anchor_resample": 0, "ransac_adaptive": 0,
                       **_fine_warps(launches["loop_relax1_device"])})
    require(host is not None and fused is not None, "relaxed loops found nothing")
    gap = _h_error(host["coarse_h"][0], fused["coarse_h"][0])
    require(gap < 0.01, f"relaxed loops: the host loop's first H is {gap} from the device's")
    readings["loop_relax1"] = {"host_homographies": int(host["coarse_h"].shape[0]),
                               "device_homographies": int(fused["coarse_h"].shape[0]),
                               "first_h_gap": gap}
    readings["align_images_ms"] = api_ms
    readings["small_pair_vs_cpu"] = small
    print(f"(g) multi-homography loop, anchor 3 + relax 1, rematch: host "
          f"{host['coarse_h'].shape[0]} homographies, device {fused['coarse_h'].shape[0]}, "
          f"first H {gap:.2e} apart; launches set_pair "
          f"{launches['loop_set_pair_anchor']}, host {launches['loop_relax1_host']}, "
          f"device {launches['loop_relax1_device']}; phase (g) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches, readings


def check_sky_against_cpu():
    """`SkySegmenter` on the card against the port on the CPU (held against
    the JAX package by tests/test_torch_segnet.py), one small image at one
    small scale, seg_id the class that wins most pixels on the CPU."""
    from ransacflow_tpu_torch.models.convert import init_segnet
    from ransacflow_tpu_torch.models.segnet import SkySegmenter

    img = _to_pil(np.random.RandomState(9).rand(48, 56, 3))
    segs = {}
    for device in ("cpu", "cuda"):
        segs[device] = SkySegmenter(*init_segnet(torch.Generator().manual_seed(0), device),
                                    device)
        segs[device].IMG_SIZES = (64,)
    scores = {d: seg.class_scores(img).cpu() for d, seg in segs.items()}
    err = (scores["cuda"] - scores["cpu"]).abs().max().item()
    # peaked seeded logits (~65 nats): cuDNN's and the CPU's fp32 orders through
    # 55 convolutions move a probability by ~2e-4 on an H100
    require(err <= 1e-3, f"sky scores: card vs CPU max abs err {err}")
    seg_id = int(torch.bincount(scores["cpu"].argmax(-1).flatten()).argmax())
    masks = {}
    for d, seg in segs.items():
        seg.seg_id = seg_id
        masks[d] = seg.get_sky(img)
    agree = float((masks["cuda"] == masks["cpu"]).mean())
    require(agree >= 0.999, f"get_sky: card and CPU agree on {agree} of the pixels")
    return {"max_abs_err": err, "mask_agree": agree, "mask_share": float(masks["cpu"].mean())}


SKY_CLASS = 2  # the eval harnesses' seg_id (build_sky_fn)


def _make_sky_partial(seg, images):
    """Seeded weights give the sky class no pixels, so the hook's mask would
    be empty. Swap the decoder's last-layer rows of the sky class and of the
    class whose share of `images` is nearest one half: the scores are only
    relabelled, and the sky mask becomes that class's partial one."""
    counts = torch.zeros(seg.decoder.conv_last[4].out_channels, device="cuda")
    for img in images:
        counts += torch.bincount(seg.class_scores(img).argmax(-1).flatten(),
                                 minlength=counts.numel())
    share = counts / counts.sum()
    cls = int((share - 0.5).abs().argmin())
    last = seg.decoder.conv_last[4]
    with torch.no_grad():
        for p in (last.weight, last.bias):
            p[[SKY_CLASS, cls]] = p[[cls, SKY_CLASS]].clone()
    return cls, float(share[cls])


def phase_sky(card):
    """(h) The sky mask: a seeded `SkySegmenter` at full width (5 scales of a
    480x640 image), then the eval harnesses' `--segNet` hook, `build_sky_fn`
    -> bg_mask -> `multi_homography_predict_fused`, on the 4 related pairs
    of (e), with a partial mask: the masked cells hold no inlier."""
    import argparse
    import tempfile

    from ransacflow_tpu_torch.cli.common import build_sky_fn
    from ransacflow_tpu_torch.models.convert import (
        alignment_params_from_tree, init_segnet, load_params_npz)
    from ransacflow_tpu_torch.models.segnet import SkySegmenter
    from ransacflow_tpu_torch.pipeline import CoarseAligner, multi_homography_predict_fused
    from ransacflow_tpu_torch.pipeline.coarse import _mask_to_cells
    from ransacflow_tpu_torch.utils.image import pyramid_shapes

    t0 = time.perf_counter()
    small = check_sky_against_cpu()
    print(f"(h) sky mask, card vs CPU (one 48x56 image, one scale): {small}", flush=True)
    enc, dec = init_segnet(torch.Generator().manual_seed(0), "cuda")
    seg = SkySegmenter(enc, dec, "cuda", seg_id=SKY_CLASS)
    img = _to_pil(_blocky(np.random.RandomState(10), 1, *TARGET_HW)[0])
    resnet, _ = _nets("cuda")
    align = alignment_params_from_tree(load_params_npz(ACCEPT_WEIGHTS), "cuda")
    srcs_np, tgts_np = _related_pairs(np.random.RandomState(1), N_PAIRS, pyramid_shapes()[0])
    sky_cls, sky_cls_share = _make_sky_partial(seg, [_to_pil(t_) for t_ in tgts_np])
    aligner = CoarseAligner(resnet, "cuda", nb_scale=7, n_iter=MH_N_ITER, min_size=480,
                            seed=MH_SEED, adaptive_chunk=MH_CHUNK)
    launches = {}
    mask, launches["sky_get_sky"] = _launches_of(lambda: seg.get_sky(img))
    _require_launched("get_sky", launches["sky_get_sky"],
                      exact={"ppm_pool": len(SkySegmenter.IMG_SIZES)})
    require(mask.shape == TARGET_HW and set(np.unique(mask)) <= {0.0, 1.0}, "get_sky: mask")
    hook = dict.fromkeys(launches["sky_get_sky"], 0)
    outs, bg_share, kept = [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(enc.state_dict(), f"{tmp}/enc.pth")
        torch.save(dec.state_dict(), f"{tmp}/dec.pth")
        args = argparse.Namespace(segNet=True, segEncoderPth=f"{tmp}/enc.pth",
                                  segDecoderPth=f"{tmp}/dec.pth")
        sky_fn = build_sky_fn(args, "cuda")
        for k in range(N_PAIRS):
            path = f"{tmp}/target{k}.png"
            _to_pil(tgts_np[k]).save(path)

            def pair(k=k, path=path):
                aligner.set_pair(_to_pil(srcs_np[k]), _to_pil(tgts_np[k]))
                bg = sky_fn(path, aligner.tgt_array.shape[:2])
                return bg, multi_homography_predict_fused(
                    aligner, align, bg_mask=bg, max_coarse=MH_MAX_COARSE,
                    mask_region_th=0.01, cycle_match=False,
                    generator=torch.Generator(device="cuda").manual_seed(MH_SEED + k))

            (bg, out), part = _launches_of(pair)  # the hook's launches, pair by pair
            hook = {name: hook[name] + n for name, n in part.items()}
            bg_share.append(float(bg.mean()))
            outs.append(out)
            # the loop's first fit is this masked RANSAC: no inlier on a masked cell
            fg = (1.0 - bg > 0.5).astype(np.float32)
            keep = _mask_to_cells(aligner.put(fg), aligner.feat_h, aligner.feat_w).cpu().numpy()
            h, inl = aligner.get_coarse(fg)
            off = 0 if h is None else int((inl.reshape(-1).astype(bool) & ~keep).sum())
            require(off == 0, f"sky loop: pair {k}: {off} inliers on masked cells")
            kept.append((int(aligner._cached_valid[torch.from_numpy(keep).cuda()].sum()),
                         aligner.num_cached_matches))
    launches["sky_hook"] = hook
    _require_launched("--segNet hook", hook, SKY_KERNELS,
                      {"ppm_pool": len(SkySegmenter.IMG_SIZES) * N_PAIRS, **_fine_warps(hook)})
    partial = [k for k, b in enumerate(bg_share) if 0.0 < b < 1.0]
    require(partial, f"sky loop: no pair has a partial mask: bg shares {bg_share}")
    require(any(kept[k][0] < kept[k][1] for k in partial),
            f"sky loop: the partial masks removed no cached match: {kept}")
    for k, out in enumerate(outs):
        require(out is not None or bg_share[k] == 0.0, f"sky loop: pair {k} found nothing")
        if out is not None:
            for key in ("coarse_h", "fine_flow_down8", "fine_match_down8"):
                require(bool(np.isfinite(out[key]).all()), f"sky loop: {key} is not finite")
    times = []
    for _ in range(3):
        t1 = time.perf_counter()
        seg.get_sky(img)
        times.append((time.perf_counter() - t1) * 1e3)
    scores_ms = min(_event_ms(lambda: seg.class_scores(img)) for _ in range(3))
    readings = {"get_sky_ms": min(times), "class_scores_ms": scores_ms,
                "sky_class": sky_cls, "sky_class_share": sky_cls_share,
                "bg_share": bg_share, "sky_share": float(mask.mean()),
                "matches_kept_of_cached": kept,
                "homographies": [None if o is None else int(o["coarse_h"].shape[0]) for o in outs]}
    print(f"(h) SkySegmenter at full width (5 scales of a 480x640 image): get_sky "
          f"{min(times):.1f} ms per image (host clock, best of 3), class_scores "
          f"{scores_ms:.1f} ms (CUDA events); sky = seeded class {sky_cls} (share "
          f"{sky_cls_share:.3f}); --segNet hook on the 4 pairs of (e): bg share {bg_share}, "
          f"cached matches kept {kept}, homographies {readings['homographies']}; launches "
          f"get_sky {launches['sky_get_sky']}, hook {hook} on {card}; phase (h) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches, readings


def _train_batch(images, n_pairs, img_size, margin):
    """(images, index_roll, grid, mask_margin) of a training step on the
    images' device."""
    from ransacflow_tpu_torch.ops.grid import normalized_grid
    from ransacflow_tpu_torch.train import local_index_roll, margin_mask

    dev = images.device
    return (images, local_index_roll(n_pairs, dev),
            normalized_grid(img_size, img_size, dev)[None],
            margin_mask(2 * n_pairs, img_size, margin, dev))


def _stage_kwargs(stage):
    from ransacflow_tpu_torch.train import STAGES

    return {k: STAGES[stage][k] for k in ("mode", "mu_cycle", "lambda_match",
                                          "grad_weight")}


def _new_trainer(device, stage):
    from ransacflow_tpu_torch.pipeline import init_alignment_params
    from ransacflow_tpu_torch.train import make_optimizer, split_trainable

    nets = init_alignment_params(torch.Generator().manual_seed(1), device)
    return nets, make_optimizer(split_trainable(nets, _stage_kwargs(stage)["mode"])[0])


def check_train_step_against_cpu():
    """One stage-3 step at IMG 32, B 2, margin 8 (tests/test_torch_train.py's
    shapes) on the card and on the CPU (held against the JAX package by
    those tests), same weights and images: the losses to 1e-4 relative, the
    BatchNorm statistics to 1e-4, and the gradients by two measures: the
    median over tensors of each tensor's max difference over its largest
    magnitude to 1e-4, and each tensor's cosine similarity to >= 0.999.
    Not each tensor to 1e-4: the step's gradients are piecewise smooth
    (ReLU and max-pool kinks, grid_sample's pixel edges), and two fp32
    implementations straddle a kink now and then. On the CPU alone, 10 of
    30 perturbations of these images by 3e-7 moved one tensor by 2.8e-2 to
    5.4e-2 of its largest magnitude (cosine >= 0.99993) while the median
    stayed at ~1.5e-5."""
    from ransacflow_tpu_torch.train import train_step

    n_pairs, img, margin = 2, 32, 8
    images = torch.from_numpy(np.random.RandomState(4).rand(2 * n_pairs, img, img, 3)
                              .astype(np.float32))
    res = {}
    for device in ("cpu", "cuda"):
        nets, opt = _new_trainer(device, 3)
        metrics = train_step(nets, opt, *_train_batch(images.to(device), n_pairs, img,
                                                      margin), **_stage_kwargs(3))
        res[device] = ({k: float(v) for k, v in metrics.items()},
                       {f"{n}.{k}": p.grad.cpu() for n, net in nets.items()
                        for k, p in net.named_parameters() if p.grad is not None},
                       {f"{n}.{k}": b.cpu().float() for n, net in nets.items()
                        for k, b in net.named_buffers()})
    (loss_c, grad_c, bn_c), (loss_g, grad_g, bn_g) = res["cpu"], res["cuda"]
    rel = max(abs(loss_g[k] - v) / max(abs(v), 1e-7) for k, v in loss_c.items())
    require(rel <= 1e-4, f"train step: losses differ from the CPU: {loss_g} vs {loss_c}")
    bn_err = max((bn_g[k] - v).abs().max().item() / max(v.abs().max().item(), 1.0)
                 for k, v in bn_c.items())
    require(bn_err <= 1e-4, f"train step: BatchNorm statistics differ by {bn_err}")
    require(grad_c.keys() == grad_g.keys() and len(grad_c) > 0, "train step: gradient sets")
    of_max = {k: ((grad_g[k] - v).abs().max() / v.abs().max()).item()
              for k, v in grad_c.items()}
    cosine = {k: torch.nn.functional.cosine_similarity(grad_g[k].flatten(), v.flatten(),
                                                       dim=0).item()
              for k, v in grad_c.items()}
    median = float(np.median(list(of_max.values())))
    worst_cos = min(cosine, key=cosine.get)
    require(median <= 1e-4, f"train step: median gradient error {median} of the largest "
                            f"magnitude: {of_max}")
    require(cosine[worst_cos] >= 0.999, f"train step: gradient {worst_cos} has cosine "
                                        f"{cosine[worst_cos]} with the CPU's")
    worst = max(of_max, key=of_max.get)
    return {"loss_rel_err": rel, "bn_stat_err": bn_err, "n_grads": len(grad_c),
            "grad_err_of_max_median": median, "grad_err_of_max_worst": of_max[worst],
            "worst": worst, "min_cosine": cosine[worst_cos]}


def _related_train_images(rng, n_pairs, img_size):
    """I1 blocky, I2 the same rolled by 4 pixels: 2 * n_pairs images."""
    i1 = _blocky(rng, n_pairs, img_size, img_size)
    return torch.from_numpy(np.concatenate([i1, np.roll(i1, (4, 4), axis=(1, 2))]))


HAND_KERNELS = ("pyramid_kernel", "blurpool_", "ssim_", "grid_sample_bwd_kernel",
                "warp_sample_kernel", "correlation_", "epilogue", "sigmoid_")
FAMILIES = (("hand kernels", HAND_KERNELS),
            ("convolutions", ("conv", "gemm", "dgrad", "wgrad", "fprop", "fft",
                              "pointwise_mult_and_sum_complex", "implicit_convolve")),
            ("batchnorm", ("batchnorm", "batch_norm", "bn_")),
            ("layout transposes", ("nchwToNhwc", "nhwcToNchw", "copy_", "transpose")),
            ("pooling", ("max_pool",)))


def _family(name):
    for family, keys in FAMILIES:
        if any(k in name for k in keys):
            return family
    return "other elementwise and reductions"


def _profile_step(step, reps=3):
    """Device time of `reps` steps from a torch.profiler trace: device ms per
    step, its share of the traced wall time, the split by kernel family, the
    top kernels and every hand kernel (K11 on the step's own grids among
    them). (The trace slows the host: the untraced step time is the
    CUDA-event median.)"""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / reps)
                   for e in prof.key_averages() if e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    device = sum(ms for _, ms in rows)
    families = {}
    for name, ms in rows:
        families[_family(name)] = families.get(_family(name), 0.0) + ms
    return {"traced_wall_ms": wall_ms, "device_ms": device,
            "families_ms": {k: round(v, 4) for k, v in
                            sorted(families.items(), key=lambda kv: -kv[1])},
            "top": [(name[:60], round(ms, 4)) for name, ms in rows[:15]],
            "hand_kernels_ms": {name.split("(float")[0][:70]: round(ms, 5) for name, ms in rows
                                if _family(name) == "hand kernels"}}


def _cli_entry_point(tmp):
    """`python -m ransacflow_tpu_torch.cli.train --stage 3 ... NoVal` for 2
    steps of the full-width batch on synthetic JPEG groups; the checkpoint is
    loaded back into fresh networks and optimizer."""
    from PIL import Image

    from ransacflow_tpu_torch.train import load_checkpoint

    data, out = f"{tmp}/data", f"{tmp}/out"
    os.makedirs(data)
    rng = np.random.RandomState(5)
    for idx in range(2 * TRAIN_PAIRS):  # two batches of groups
        base = (_blocky(rng, 1, 256, 320)[0] * 255).astype(np.uint8)
        for view, shift in ((1, 0), (2, 6)):
            Image.fromarray(np.roll(base, shift, axis=1)).save(f"{data}/{idx}_{view}.jpg")
    cmd = [sys.executable, "-m", "ransacflow_tpu_torch.cli.train", "--trainImgDir", data,
           "--outDir", out, "--stage", "3", "--batchSize", str(TRAIN_PAIRS),
           "--imgSize", str(TRAIN_IMG), "--margin", str(TRAIN_MARGIN), "--nEpochs", "1",
           "--maxStepsPerEpoch", "2", "--device", "cuda", "NoVal", "--epochSaveModel", "1"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0, f"cli.train exited {proc.returncode}:\n"
                                  f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    recs = [json.loads(line) for line in open(f"{out}/metrics.jsonl")]
    last = recs[-1]
    require(last["step"] == 0 and all(np.isfinite(last[k]) for k in ("loss", "loss_lr",
                                                                       "loss_cycle",
                                                                       "loss_match")),
            f"cli.train: epoch record {last}")
    nets, opt = _new_trainer("cuda", 3)
    ckpt = load_checkpoint(f"{out}/checkpoint_epoch0.pt", nets, opt)
    require(ckpt["step"] == 0 and len(opt.state_dict()["state"]) > 0,
            "cli.train: the checkpoint did not load back")
    w = nets["netFlowCoarse"].conv1.weight
    require(w.device.type == "cuda" and bool(torch.isfinite(w).all()),
            "cli.train: loaded weights")
    return {"seconds": seconds, "epoch_record": last}


def phase_train(card):
    """Stage 3 at full width (16 pairs of 224x224, margin 88, k 7, Adam
    2e-4 / (0.5, 0.999)), after the small step against the CPU; then one
    stage-1 step and the CLI entry point."""
    import tempfile

    from ransacflow_tpu_torch import kernels
    from ransacflow_tpu_torch.kernels import warp_sample
    from ransacflow_tpu_torch.train import train_step

    small = check_train_step_against_cpu()
    print(f"(f) small stage-3 step, card vs CPU: {small}", flush=True)

    rng = np.random.RandomState(6)
    batch = _train_batch(_related_train_images(rng, TRAIN_PAIRS, TRAIN_IMG).cuda(),
                         TRAIN_PAIRS, TRAIN_IMG, TRAIN_MARGIN)
    nets, opt = _new_trainer("cuda", 3)
    step = lambda: train_step(nets, opt, *batch, **_stage_kwargs(3))  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    warp_sample.reset_tile_counts()
    first = step()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    shared, glob = warp_sample.tile_counts("cuda").tolist()
    k11_share = shared / (shared + glob)
    require(all(launches[k] > 0 for k in TRAIN_KERNELS),
            f"training path: kernel not launched: {launches}")
    first = {k: float(v) for k, v in first.items()}
    require(all(np.isfinite(v) for v in first.values()), f"stage 3: losses {first}")
    for _ in range(2):  # warm-up
        step()
    times = []
    for _ in range(12):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    last = {k: float(v) for k, v in metrics.items()}
    require(all(np.isfinite(v) for v in last.values()), f"stage 3: losses {last}")
    step_ms = float(np.median(times))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = _profile_step(step)
    # the device's idle share of the untraced step, on the device's timeline
    profile["idle_share"] = max(0.0, 1.0 - profile["device_ms"] / step_ms)
    print(f"(f) stage 3 at full width ({TRAIN_PAIRS} pairs, {TRAIN_IMG}x{TRAIN_IMG}, "
          f"margin {TRAIN_MARGIN}): step ms median of {len(times)} {step_ms:.3f} "
          f"(min {min(times):.3f}, max {max(times):.3f}) = "
          f"{TRAIN_PAIRS / (step_ms / 1e3):.3f} trained pairs/s; peak memory "
          f"{peak_gb:.2f} GB; first step {first}; step 15 {last}; launches "
          f"{launches}; K11 tiles through shared memory in the first step "
          f"{shared} of {shared + glob} ({k11_share:.4f}) on {card}", flush=True)
    print(f"(f) one step in the profiler: {profile}", flush=True)
    del nets, opt, batch

    nets1, opt1 = _new_trainer("cuda", 1)
    batch1 = _train_batch(_related_train_images(rng, TRAIN_PAIRS, TRAIN_IMG).cuda(),
                          TRAIN_PAIRS, TRAIN_IMG, TRAIN_MARGIN)
    stage1 = {k: float(v) for k, v in
              train_step(nets1, opt1, *batch1, **_stage_kwargs(1)).items()}
    require(all(np.isfinite(v) for v in stage1.values()) and stage1["loss_match"] == 0.0,
            f"stage 1: losses {stage1}")
    print(f"(f) stage 1 step at full width: {stage1}", flush=True)
    del nets1, opt1, batch1

    with tempfile.TemporaryDirectory() as tmp:
        cli = _cli_entry_point(tmp)
    print(f"(f) cli.train --stage 3 NoVal, 2 steps at full width: {cli}", flush=True)
    return launches, {"step_ms": step_ms, "step_ms_all": times,
                      "pairs_s": TRAIN_PAIRS / (step_ms / 1e3), "peak_gb": peak_gb,
                      "k11_shared_tile_share": k11_share, "profile": profile}


SOURCES = {
    "lanczos_pyramid": ("cuda", "ransacflow_tpu_torch/csrc/pyramid.cu",
                        "ransacflow_tpu/pipeline/fused.py:30"),
    "mutual_argmax": ("cuda", "ransacflow_tpu_torch/csrc/matching.cu",
                      "ransacflow_tpu/ops/matching.py:24"),
    "ransac_score": ("cuda", "ransacflow_tpu_torch/csrc/ransac.cu",
                     "ransacflow_tpu/ops/ransac.py:102"),
    "ransac_adaptive": ("cuda", "ransacflow_tpu_torch/csrc/ransac_adaptive.cu",
                        "ransacflow_tpu/ops/ransac.py:194"),
    "warp_sample": ("cuda", "ransacflow_tpu_torch/csrc/warp_sample.cu",
                    "ransacflow_tpu/ops/sampler.py:240"),
    "warp_homography": ("cuda", "ransacflow_tpu_torch/csrc/warp_sample.cu",
                        "ransacflow_tpu/ops/homography.py:32"),
    "correlation_volume": ("cuda", "ransacflow_tpu_torch/csrc/correlation.cu",
                           "ransacflow_tpu/ops/correlation.py:21"),
    "head_epilogues": ("triton", "ransacflow_tpu_torch/kernels/heads_triton.py",
                       "ransacflow_tpu/models/heads.py:69"),
    "compose_tail": ("cuda", "ransacflow_tpu_torch/csrc/compose.cu",
                     "ransacflow_tpu/pipeline/fine.py:61"),
    "blur_pool": ("cuda", "ransacflow_tpu_torch/csrc/blurpool.cu",
                  "ransacflow_tpu/ops/blurpool.py:42"),
    "blur_pool_bwd": ("cuda", "ransacflow_tpu_torch/csrc/blurpool.cu",
                      "ransacflow_tpu/ops/blurpool.py:42"),
    "masked_ssim": ("cuda", "ransacflow_tpu_torch/csrc/ssim.cu",
                    "ransacflow_tpu/ops/ssim.py:57"),
    "masked_ssim_bwd": ("cuda", "ransacflow_tpu_torch/csrc/ssim.cu",
                        "ransacflow_tpu/ops/ssim.py:57"),
    "grid_sample_bwd": ("cuda", "ransacflow_tpu_torch/csrc/grid_sample_bwd.cu",
                        "ransacflow_tpu/ops/sampler.py:211"),
    "correlation_volume_bwd": ("cuda", "ransacflow_tpu_torch/csrc/correlation.cu",
                               "ransacflow_tpu/ops/correlation.py:21"),
    "head_epilogues_bwd": ("triton", "ransacflow_tpu_torch/kernels/heads_triton.py",
                           "ransacflow_tpu/models/heads.py:69"),
    "anchor_resample": ("cuda", "ransacflow_tpu_torch/csrc/anchor_resample.cu",
                        "ransacflow_tpu/pipeline/coarse.py:70"),
    "ppm_pool": ("cuda", "ransacflow_tpu_torch/csrc/adaptive_pool.cu",
                 "ransacflow_tpu/models/segnet.py:148"),
}


def main():
    try:
        card = phase_card()
        phase_build()
        results = phase_kernels()
        serving, exact_pairs_s = phase_serving(card)
        multihomo, readings = phase_multihomo(card)
        train, train_readings = phase_train(card)
        fast, fast_readings = phase_fast_modes(card, exact_pairs_s)
        sky, sky_readings = phase_sky(card)
    except Exception:  # the boundary: report and fail
        traceback.print_exc()
        return 1
    by_path = {"serving": serving, **multihomo, "train": train, **fast, **sky}
    kernels = [{"name": name, "route": route, "source": src, "replaces": rep,
                "launches": sum(p[name] for p in by_path.values()),
                "launches_by_path": {path: p[name] for path, p in by_path.items()},
                **{key: results[name][key] for key in
                   ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "device_ms", "plain_device_ms", "library_device_ms")}}
               for name, (route, src, rep) in SOURCES.items()]
    print(json.dumps({"multihomo": readings, "train": train_readings,
                      "fast_modes": fast_readings, "sky": sky_readings,
                      "kernel_details": results}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
