#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port once on one CUDA card: the serving path,
the multi-homography loop, training, the opt-in fast modes through the
public entry points, the sky mask, the eval harnesses, affine fits,
iterative refinement, MegaDepth validation, the eval pool and the bf16
policies with remat, data parallelism (on four cards where there are
four), the serving loop's batch modes, and the JAX surface outside them
(the reference-API heads, the surface ops, the synthetic demo, a profiler
trace).

    python3 chip_smoke.py

Phases, each of which must pass:
  (a) card: a CUDA device is present; prints its name and power limit;
  (b) build: compiles the CUDA kernels from `ransacflow_tpu_torch/csrc/`;
  (c) kernels: each hand-written kernel (K1-K15, K5 in its grid and its
      homography form, the backward kernels of K6, K7, K9 and K10 under
      their own names, and K2 with relax_cells 1 and with the target mask
      applied in the kernel) against its plain PyTorch version at its
      path's shapes (K1 the serving pyramid, K2 the serving score bit for
      bit, K6 forward the
      fine stage's (1, 60, 80, 256) and the training step's (32, 28, 28,
      256), its pair form the fine stage's and bit for bit the kernel's two
      volumes, K5's homography form the fine stage's 480x640 warp, K12 a
      serving pair's four anchor resamples and its whole 7-scale bank in one
      launch, K7 a fine pass's three epilogues in one launch (match_down8
      bit for bit the two sigmoids, one device kernel a call, and whether
      `nhwc` copies conv4's output) and the training heads' two launches,
      K13 the sky mask's conv5 maps (two device kernels a call: the
      segment cells' sums, then the bins), the backward kernels and
      K9-K11 the full-width training step's; K9 forward and backward at the
      step's three calls (the stem, layer2's and layer3's downsample); K8
      also across resolutions, a 368x1232 coarse grid composed at 375x1242,
      and with a residual that sends match21's corners outside the patch
      its blocks stage (one device kernel a call); K14 at the trunk's
      layer1 and layer3 calls (with and without the shortcut, bit for bit
      its plain version), then the frozen trunk (BatchNorm folded, K14)
      against the unfolded one at the serving pyramid's shapes and the
      target's (`trunk_gap_*`, 40 launches a pass); K15 at every fine-stage
      convolution of the alignment cells at batch 32 and 1 (`_<name>_b<batch>`
      keys, within 2e-5 of its plain version's largest output; `library_ms`
      cuDNN's pick in the unfolded network's layout), then a whole fine pass
      on the accepted weights, frozen against unfolded (`fine_gap_*`, 42
      launches a pass);
      K11 at the step's three calls, each on a per-pixel-noise grid and an
      upsampled random flow's grid, with the share of its tiles that
      splatted through shared memory, at least 90% on the latter at C = 1
      and 2), with max
      error, paired times (CUDA events and profiler device time), the time
      of one PyTorch call that computes the same function where there is one
      (`library_ms`), and the least time the card could take for the work
      (`bound_ms`: bytes over 3.35 TB/s or operations over 67 TFLOP/s fp32,
      whichever is larger) and its share of the device time; K3 and K4 are
      whole fits (draws, solve, score, winner and mask) against their plain
      versions on the same seed, at 10k and 50k hypotheses (K3) and one
      block and 13 (K4), timed as the ops a path calls (the seed draw and
      one launch) and as the kernel alone (`kernel_device_ms`); K4 runs
      under sync-debug 'error'; then each wrapper on k = 2 and 4 pairs at
      once (`BATCH_CHECKS`), against its plain twin and bit for bit against
      each pair's own launch, with `singles_ms` the k one-pair launches:
      K2 exact, relaxed and masked at k serving scores (`_batch<k>` keys),
      K12 at k 7-scale stride-3 banks (`_bank_batch<k>`), K3 at 10k
      hypotheses (`_batch<k>`), K4 to the cap and with stops that differ by
      pair, under sync-debug 'error' (`_to_cap_batch4`, `_stops_batch<k>`),
      and K5h at B = 4 (`_b4`);
  (d) serving path: `fused_align_batch` over 4 pairs at full width (480x640
      targets, 7-scale pyramid from 960x1280, 10k RANSAC hypotheses, fp32,
      seeded weights), checked for finite outputs, against the plain CPU path
      on a small pair, and for launches of its kernels: lanczos_pyramid (K1),
      mutual_argmax (K2), ransac_score (K3), warp_homography (K5, one per
      pair, and no grid-form warp_sample), correlation_pair (K6's pair
      form: both volumes, one per pair, and no single correlation_volume),
      head_epilogues (K7: a pair's three epilogues, one launch), compose_tail
      (K8), blur_pool (K9), conv_epilogue (K14, the frozen trunk) and
      fine_conv (K15, 42 a pair: the frozen fine networks); prints
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
      K10, K11 and the backward kernels; K7 twice forward and twice
      backward), K11's shared-tile share in the
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
      first pair; launches of the serving kernels, anchor_resample (K12, one
      per bank) and ransac_adaptive (K4); the device kernels of one
      rematching call, printed: the score GEMM and K2, no elementwise pass;
  (h) sky mask: `SkySegmenter` on the card against the CPU on a small image,
      then a seeded one at full width (5 scales of a 480x640 image, ms per
      image), and the `--segNet` hook (`cli.common.build_sky_fn` ->
      bg_mask -> `multi_homography_predict_fused`) on the 4 related pairs of
      (e); launches of ppm_pool (K13) and the loop's kernels;
  (i) eval harnesses: synthetic sets written to a temporary directory
      (numpy from a seed, PIL; KITTI's 16-bit ground truth by a zlib PNG
      writer), the predict and results passes of each at its defaults on
      the card: HPatches (2 pairs of 640x480, planted translations, 7
      scales, 50k hypotheses, max_coarse 10, AEPE at 240x240), KITTI 2015
      (2 pairs of 1242x375, a planted 15-row shift, coarseSize 800, 3
      scales, fineSize 650, cc_th 0.01) and corr (2 pairs of 640x480, 40
      annotated points each, 10k hypotheses, cycle match); seeded trunk,
      alignment nets from accept_weights.npz. Each artifact finite, of the
      JAX package's fields, 1 to max_coarse + 1 homographies; launches of
      K2, K3, K5h, K6's pair, K7, K8 and K9 (KITTI also K5's grid form and
      three K8 an iteration), K8 once a pair in the results passes (twice
      for KITTI); each results pass on the card against the CPU's on the
      same artifacts (HPatches' AEPE within 1e-3 px, corr's precision and
      counts equal, KITTI's EPE within 1e-3 px off the pixels whose
      th = 1.0 or cc decision flips on a last-bit difference of the
      matchability, its composed stacks within 1e-5); K8 against its plain
      version on KITTI's real pass-2 and inter-pass shapes from an
      artifact (keys `_kitti`, `_kitti_grid` of its row); pairs/s, results
      ms, KITTI's host share (the cc cleanup) and the coarse-only metrics
      against the planted truth printed;
  (j) YFCC, Aachen and generate_pairs: a YFCC scene (2 pairs of 640x480, a
      textured plane seen by two calibrated cameras, planted translations,
      pair 1's target stored turned by 90 degrees) through `predict_yfcc` at
      the reference's defaults (min side 480, 7 scales, 10k hypotheses,
      tolerance 0.05, max_coarse 10, maskRegionTh 0.01, a fresh masked match
      every call, cycle match) in the host loop and the device loop; the
      pre-test picks 0 and 270; launches of K2, K3, K5h, K6's pair, K7, K8
      and K9; the results pass (--multiH --ransac, th 0.95, threshold
      0.0005; calibration records handed in, no h5py on the card) on the
      card against the CPU on the same artifacts and pose seed (composed
      stacks within 1e-5, matched pixels equal but at th flips, points
      within 1e-5 (w - 1) / 2 px, equal errors on equal points); the pose
      estimator's host time, points and minimal sets; the Aachen export on
      one pair and its match file; `cli.generate_pairs` on a kept (planted
      shift) and a rejected (noise against a flat image) row, K2 and K3 a
      row and K5h for the kept one;
  (k) affine fits, refinement, validation and --nativeResize: K3 and K4 in
      their affine form at the serving shape (1200 matches, 10k hypotheses;
      K4 in blocks of 4096, one block and to the 50k cap) and past the
      40,960 matches of the shared-memory order (K3 at refine's 307,200
      matches and 1,000 hypotheses, homography and affine; one K4 fit there
      in blocks of 1024) against their plain versions on one seed (sets
      and winner identical, H21 within 1e-5, counts as in (c), masks equal),
      timed as in (c) under the suffixes `_affine`, `_affine_to_cap`,
      `_refine`, `_refine_affine` and `_large`; `CoarseAligner(transform=
      'affine')` on a small pair against the CPU on the same 3-cell sets
      (H within 1e-5, equal inlier cells) and its device loop on (e)'s pair
      0 at the HPatches configuration (K3 once a slot, path
      `affine_multihomo`) against the host loop; `refine_flow_ransac` at
      480x640 on a planted flow (path `refine`: one K3 over 307,200 matches,
      one grid-form K5, K6's pair, K7, K8) against the CPU's plain path on
      the sets the card drew (count equal, refined_h within 1e-5, the fine
      outputs within 1e-3), ms a call; `validate` on two rows of 480x640
      images at min side 480 (path `validation`: K5 twice, K9 six times, K6
      and K7 once a row), zero-flow networks giving the planted precision on
      the card and the CPU, the fine grid of the accept weights within 1e-3
      of the CPU's, seconds a row; and `python -m
      ransacflow_tpu_torch.cli.train --stage 3 ... --nativeResize
      valMegaDepth ...` for 1 epoch of 2 steps at full width, warm-started
      from zero-flow networks, which must write BestModel@8_*.
  (l) pool, bf16, remat: phase (i)'s HPatches pairs and phase (j)'s YFCC
      pairs through `--nDevices 1`, `--nDevices 1 --batchPairs 2` and a
      pool of two slots on cuda:0 (`n_devices=["cuda:0", "cuda:0"]`), and
      `pooled_kitti_predict` with two slots against the sequential KITTI
      pass: the artifacts equal bit for bit (else the largest difference,
      held to POOL_TOL); the boundary casts' cost at the eval path's shapes
      (each bf16 wrapper against its fp32 upcast, and the matching GEMM in
      bf16 with an fp32 score); the serving path and the device loop on
      (e)'s 4 related pairs at the headline shape in fp32 and bf16 (the eval
      policy), timed in turns: pairs/s, MFU against the dense peak of the
      dtype (`utils.flops`), homographies a pair, a profiler split, each bf16
      H within JAX's tests' tolerance of fp32's (0.05, 0.01); one bf16
      anchor-mode serving call (K12 on bf16 maps); `cli.eval_hpatches
      predict --computeDtype bfloat16` (one pair a scene); the stage-3
      step at full width in fp32, bf16 (the training policy), with remat
      and with both: step ms, peak GB, step 0's loss (bf16 within 5e-3 of
      fp32's; remat equal to the plain step's, and its BatchNorm
      statistics), fp32 masters and Adam state; every bf16 path launching
      the kernels bf16 reaches (K2, K6's pair, K7, K8, K9; K12 in the anchor
      call; K7 and its backward in training).
  (m) data parallelism: the stage-3 step at full width (16 global pairs)
      over two ranks on cuda:0 (gloo carries CUDA tensors; NCCL refuses
      two ranks on one card; one NCCL rank if gloo cannot) against one
      process on the whole batch: losses and BatchNorm statistics to
      1e-4, the ranks' reduced gradients equal, each against the single
      step's by cosine >= 0.999, norm within 1% and a median max error
      <= 1e-2 of the largest magnitude (the single step run twice gives
      the card's floor); every training kernel launched on each rank;
      K10's global form at the training shape against its plain twin and
      against the kernel on the whole batch (keys `_global` of K10's
      rows); `sharded_align_pairs` of (d)'s pairs and `sharded_ransac`
      (10k hypotheses) over two slots of cuda:0, bit for bit one device's
      run, `fused_align_batch` on the per-pair seeds and the shards' own
      fits. With four or more cards also: NCCL, one rank a card, the step
      at 16 pairs a card and at 16 global pairs against one card's step in
      the same call (median of 12, pairs/s, peak GB a card, the NCCL
      kernels' device ms, weak and strong efficiency), the 16-global run
      held to the one-process step; `cli.train --distributed` under
      torchrun and `cli.train --nDevices 4` for 2 steps, checkpoints
      loaded back; sharded serving of 32 pairs over four cards against one
      card in turns (bit for bit, pairs/s); HPatches, YFCC and KITTI
      predict over a pool of four cards against one slot (POOL_TOL); and
      `sharded_ransac` over four cards.
  (n) batch modes: `fused_align_batch` on (d)'s 4 pairs in `scan`,
      `vmap`, `hybrid`, `chunk2`, `chunkf2` and `chunkv2`, in fp32 (TF32
      off) and bf16 (the eval policy), then `chunk2` at anchor stride 3
      with relax_cells 1 (bench.py's fast-mode series) and `vmap` with
      adaptive RANSAC (blocks of 4096), each beside `scan` and a mode of
      the same coarse step that fits the other way (`chunkv2`, `hybrid`)
      in its own configuration: the coarse matches against scan's (a differing cell
      must be a near tie of scan's score, its margin printed, at most 1%
      of the cells in fp32), H21 within 1e-5 and inliers equal (or apart
      by matches on the tolerance boundary) on the pairs whose matches
      are equal, the flow within 1e-3 there in fp32; each mode also held
      so to the first mode with its coarse step (hybrid to vmap, chunkf2
      and chunkv2 to chunk2, in each configuration), whose matches it must
      equal: where bf16's roundings leave no pair with scan's matches, this
      holds the batched fits and fine stage to the per-pair ones; the launches of K2,
      K3, K4 and K12 a call (K2 4 / 1 / 1 / 2 / 2 / 2 and K3 4 / 1 / 4 /
      4 / 4 / 2 for the six modes); pairs/s (CUDA events, best of 3 after
      the checked call), peak memory and the card's idle share of one
      traced call;
  (o) the JAX surface outside the main paths: `models.heads.
      pred_flow_coarse` and `pred_matchability` under grad at a fine
      pass's (1, 60, 80, 49), through K7 (twice forward and twice
      backward) against K7's plain twins on the card (values and the
      gradient to the correlation within 1e-5 of their scale) and against
      the CPU (values within 1e-4, the gradient within 1e-2 relative L2:
      ReLU gates at 0 flip between the devices), their CUDA-event and
      device times; `saliency_coef`, `fit_hough`, `fit_translation` and
      `blur_pool_1d` on CUDA tensors against the CPU; the synthetic demo
      (`python -m ransacflow_tpu_torch.examples.synthetic_demo --device
      cuda`, through its `main`) twice: the planted translation within
      0.02 normalized, its three blends, the launches of K2, K3, K5h, K6's
      pair, K7, K8, K9 and two grid-form K5 (the target's synthesis and
      warped_fine), wall seconds of each call; one full-width serving call
      inside `utils.monitor.profile_trace`, whose trace file must name a
      hand kernel.
Each path's launch counts are set to 0 just before it and read just after;
a kernel's `launches` is the sum over the paths. Every fine pass of an
alignment path warps through warp_homography, correlates through
correlation_pair and runs its head epilogues through head_epilogues: one
launch each per compose_tail launch, no correlation_volume, and no
grid-form warp_sample but align_images' warped_fine and KITTI's pass 2.
Phase (j)'s paths are `eval_yfcc` (host-loop predict and results),
`eval_yfcc_device`, `eval_aachen` and `generate_pairs`; phase (k)'s
`affine_multihomo`, `refine` and `validation`; phase (l)'s
`{hpatches,yfcc}_pool_{one,batched,two_slots}`, `kitti_pool_two_slots`,
`eval_hpatches_bf16`, `{serving,multihomo}_{fp32,bf16}`,
`serving_bf16_anchor` and `train_{fp32,bf16,remat,bf16_remat}`; phase
(m)'s `dp_train` (the ranks' launches summed), `sharded_serving` and
`sharded_ransac`, and on four cards `dp_train_4_cards`,
`sharded_serving_4_cards`, `{hpatches,yfcc}_{one_slot,four_cards}`,
`kitti_four_cards` and `sharded_ransac_4_cards`; phase (n)'s
`batch_<mode>[_anchor|_adaptive]_<fp32|bf16>`; phase (o)'s `surface_pred_heads`,
`surface_demo` and `surface_traced_serving`.

Its last three lines are the card (nvidia-smi name, power limit), a JSON
object with the kernels' numbers, and `{"ok": true, "device": {...}}`. It
exits non-zero, without that last line, on any failure or without CUDA.
"""

import functools
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
                   "correlation_pair", "head_epilogues", "compose_tail", "blur_pool")
MULTIHOMO_KERNELS = SERVING_KERNELS + ("ransac_adaptive",)
TRAIN_KERNELS = ("warp_sample", "grid_sample_bwd", "correlation_volume",
                 "correlation_volume_bwd", "head_epilogues", "head_epilogues_bwd",
                 "blur_pool", "blur_pool_bwd", "masked_ssim", "masked_ssim_bwd")


HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
# RANSAC arithmetic per (hypothesis, match): the homography applied (15), the
# divide (2), the squared residual (5) and the tolerance test and count (2);
# per hypothesis the draws (Philox4x32-10's 10 rounds of 2 multiplies high
# and low, 4 xors and 2 key adds, and 4 ranks), the Hartley normalization
# and the closed-form 4-point solve
RANSAC_OPS_PER_MATCH, RANSAC_OPS_PER_SOLVE = 24, 350


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


def paired_ms(kernel_fn, plain_fn, reps=20, suffix="", plain_reps=None):
    """Kernel and plain milliseconds per call: `ms` from CUDA events around
    back-to-back calls (host launch time included), measured in turns
    kernel, plain, plain, kernel; `device_ms` the kernels' own device time.
    `plain_reps`: fewer calls of a slow plain version (after one warm-up)."""
    p_reps, p_warm = (reps, 3) if plain_reps is None else (plain_reps, 1)
    k1 = cuda_ms(kernel_fn, reps)
    p1, p2 = (cuda_ms(plain_fn, p_reps, p_warm) for _ in range(2))
    k2 = cuda_ms(kernel_fn, reps)
    return {"ms" + suffix: (k1 + k2) / 2, "plain_ms" + suffix: (p1 + p2) / 2,
            "device_ms" + suffix: device_ms(kernel_fn, reps),
            "plain_device_ms" + suffix: device_ms(plain_fn, p_reps)}


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
    """K6 forward at the fine stage's (1, 60, 80, 256) and, suffix `_train`,
    the training step's (32, 28, 28, 256); its pair form (both fine-stage
    volumes from one launch) at the fine stage's shape, whose corr(y, x)
    must equal the kernel's own corr(y, x) bit for bit. k = 7."""
    from ransacflow_tpu_torch.kernels.correlation import (
        correlation_pair, correlation_pair_ref, correlation_volume, correlation_volume_ref)

    vol, pair = {}, {}
    for suffix, shape in (("", CORR_SHAPE), ("_train", (*TRAIN_FEAT, 256))):
        x = _normalized(shape, -1, gen)
        y = _normalized(shape, -1, gen)
        got = correlation_volume(x, y, 7)
        torch.cuda.synchronize()
        err = (got - correlation_volume_ref(x, y, 7)).abs().max().item()
        # fp32 sums of 256 products of unit-norm vectors, in another order
        require(err <= 1e-4, f"correlation{suffix}: max abs err {err} > 1e-4")
        vol.update({"max_abs_err" + suffix: err,
                    **paired_ms(lambda: correlation_volume(x, y, 7),
                                lambda: correlation_volume_ref(x, y, 7), suffix=suffix),
                    **bound(nbytes(x, y, got), 2 * got.numel() * x.shape[-1], suffix),
                    **library(None, suffix)})
        if suffix:
            continue
        xy, yx = correlation_pair(x, y, 7)
        want = correlation_pair_ref(x, y, 7)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip((xy, yx), want))
        require(err <= 1e-4, f"correlation_pair: max abs err {err} > 1e-4")
        require(torch.equal(xy, got) and torch.equal(yx, correlation_volume(y, x, 7)),
                "correlation_pair: not bit for bit the two volumes' kernel")
        # x, y and both volumes move; the operations are one volume's
        pair.update({"max_abs_err": err,
                     **paired_ms(lambda: correlation_pair(x, y, 7),
                                 lambda: correlation_pair_ref(x, y, 7)),
                     **bound(nbytes(x, y, xy, yx), 2 * xy.numel() * x.shape[-1]),
                     **library(None)})
    return vol, pair


def check_matching(gen):
    """K2 at the serving shape (13065 x 1200), every output bit for bit
    against its plain version: the raw score with planted ties (rows of one
    warp and of other chunks of `kernels/matching.schedule`) and a NaN in a
    masked column, exact (no suffix), relax_cells=1 on the 30
    x 40 target grid (`_relaxed`), the mask applied by the kernel as it
    reads (`_masked`, `_masked_relaxed`: checked, not timed), and nB = 1199
    with the mask (4-byte loads, `_nb1199`)."""
    from ransacflow_tpu_torch.kernels.matching import mutual_argmax, mutual_argmax_ref, schedule

    _, rows, _, _ = schedule(N_BANK, N_TARGET, True,
                             torch.cuda.get_device_properties(0).multi_processor_count)
    # bank rows 57, 57 + 8 (the same warp of one chunk) and 57 + rows (the
    # next chunk) tie exactly as the best source of target 5; rows 300 and
    # 12001 tie as target 6's
    tie5 = (57, 57 + 8, 57 + rows)
    require(57 // rows == 65 // rows, "planted ties: rows 57 and 65 not in one chunk")
    feat_a = _normalized((N_CHANNELS, N_BANK), 0, gen)
    feat_b = _normalized((N_CHANNELS, N_TARGET), 0, gen)
    feat_a[:, list(tie5[1:])] = feat_a[:, 57:58]
    feat_b[:, 5] = feat_a[:, 57]
    feat_a[:, 12001] = feat_a[:, 300]
    feat_b[:, 6] = feat_a[:, 300]
    valid_b = torch.rand(N_TARGET, generator=gen, device="cuda") > 0.1
    valid_b[5] = valid_b[6] = True
    valid_b[8] = False
    score = feat_a.T @ feat_b
    score[77, 8] = float("nan")  # masked, it stays NaN: row 77 and target 8 match
    require(len({score[r, 5].item() for r in tie5}) == 1
            and score[300, 6].item() == score[12001, 6].item(), "planted ties are not exact")
    cases = (("", (score, 0, None, None)), ("_relaxed", (score, 1, 40, None)),
             ("_masked", (score, 0, None, valid_b)), ("_masked_relaxed", (score, 1, 40, valid_b)),
             ("_nb1199", (score[:, :1199].contiguous(), 0, None, valid_b[:1199])))
    out = {}
    for suffix, args in cases:
        got = mutual_argmax(*args)
        want = mutual_argmax_ref(*args)
        torch.cuda.synchronize()
        for name, g, w in zip(("best_src", "best_tgt", "valid", "pair_score"), got, want):
            same = torch.equal(g.view(torch.int32), w.view(torch.int32)) if g.is_floating_point() \
                else torch.equal(g, w)
            require(same, f"matching{suffix}: {name} differs from the plain version")
        require(got[0][5].item() == 57 and got[0][6].item() == 300,
                f"matching{suffix}: a tie did not go to the lowest index")
        if args[3] is not None:
            lone = ~args[3]
            lone[8] = False  # the masked NaN column matches, as in the reference
            require(not got[2][lone].any().item(), f"matching{suffix}: a masked target matched")
        out["max_abs_err" + suffix] = torch.where(torch.isnan(want[3]), 0.0,
                                                  (got[3] - want[3]).abs()).max().item()
        out["n_valid" + suffix] = int(got[2].sum())
        if suffix == "_masked_relaxed":
            continue
        out.update(paired_ms(lambda: mutual_argmax(*args), lambda: mutual_argmax_ref(*args),
                             suffix=suffix))
        # the score (and the mask) read once; a comparison per element for each argmax
        out.update(bound(nbytes(*[a for a in args if isinstance(a, torch.Tensor)], *got),
                         2 * args[0].numel(), suffix))
        s, mask = args[0], args[3]
        if mask is None:
            out.update(library(lambda: (torch.argmax(s, 0), torch.argmax(s, 1)), suffix))
        else:  # the mask as its own pass, then both argmaxes
            out.update(library(lambda: [torch.argmax(m, d) for m in (s * mask[None],)
                                        for d in (0, 1)], suffix))
    require(out["n_valid_relaxed"] >= out["n_valid"], "matching: relaxing lost matches")
    if out["device_ms"] and out["device_ms_masked"]:
        out["masked_over_unmasked"] = out["device_ms_masked"] / out["device_ms"]
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


def _ransac_against_plain(name, fit, rec, ref, rec_ref, m1, m2, valid,
                          transform="homography", atol=1e-4):
    """A RANSAC kernel's fit against its plain version's on the same seed:
    identical sets and winning set, counts that agree on >= 99.9% of the
    hypotheses (a differing count agrees only when a flip at the tolerance
    boundary explains it, `kernels.ransac.boundary_flips`: fp32 solves in
    another order of operations), equal winning count and found, H21 to
    `atol`, the mask equal off matches within 1e-6 of the tolerance."""
    from ransacflow_tpu_torch.kernels.ransac import boundary_flips
    from ransacflow_tpu_torch.ops.homography import reprojection_error

    n_rows = rec_ref.counts.shape[0]
    require(torch.equal(rec.sets[:n_rows], rec_ref.sets), f"{name}: sets differ")
    differ, explained = boundary_flips(m1, m2, valid, rec_ref.sets, rec.counts[:n_rows],
                                       rec_ref.counts, 0.05, transform=transform)
    agree = 1 - (differ & ~explained).float().mean().item()
    require(agree >= 0.999, f"{name}: counts agree on only {agree:.5f}")
    require(int(fit.num_inliers) == int(ref.num_inliers),
            f"{name}: winning count {int(fit.num_inliers)} vs plain {int(ref.num_inliers)}")
    require(bool(fit.found) == bool(ref.found), f"{name}: found differs")
    require(torch.equal(fit.best_sample, ref.best_sample), f"{name}: winning sets differ")
    err = (fit.H21 - ref.H21).abs().max().item()
    require(err <= atol, f"{name}: winner H21 max abs err {err} > {atol}")
    off = ((reprojection_error(m1, m2, ref.H21[None])[0] - 0.05).abs() > 1e-6)
    require(torch.equal(fit.inlier_mask[off], ref.inlier_mask[off]), f"{name}: masks differ")
    return {"max_abs_err": err, "counts_agree": agree,
            "counts_equal": 1 - differ.float().mean().item(),
            "counts_differ": int(differ.sum()), "counts_flips": int((differ & explained).sum()),
            "mask_on_boundary": int((~off).sum())}


def _ransac_bound(m1, m2, valid, seed, n_hyp, suffix=""):
    """The matches and the seed read once, H21, count, set, mask and found
    written once; the operations of n_hyp hypotheses over the valid matches
    and of the mask over all of them."""
    n_valid = int(valid.sum())
    ops = (n_hyp * (n_valid * RANSAC_OPS_PER_MATCH + RANSAC_OPS_PER_SOLVE)
           + m1.shape[0] * RANSAC_OPS_PER_MATCH)
    return bound(nbytes(m1, m2, valid, seed) + 9 * 4 + 5 * 4 + m1.shape[0] + 1, ops, suffix)


def check_ransac(gen):
    """K3 at the serving shape (1200 matches, 10k hypotheses) and, suffix
    `_50k`, the loop's fixed-count slot (50k): the kernel's fit against the
    plain version's on the same seed; the whole op timed (the seed draw and
    one launch, against the seed draw and the plain fit). `gen` gives the
    matches and one seed; the other seeds come from a generator of this
    check's own, so that the later checks' inputs do not depend on how
    often this one draws."""
    from ransacflow_tpu_torch.kernels.ransac import ransac_fit, ransac_fit_ref
    from ransacflow_tpu_torch.ops.ransac import draw_seed, ransac_homography

    m1, m2, valid = _ransac_matches(gen)
    own = torch.Generator(device="cuda").manual_seed(N_ITER)
    out = {}
    for suffix, n_iter in (("", N_ITER), ("_50k", MH_N_ITER)):
        seed = draw_seed(own if suffix else gen, "cuda")
        fit, rec = ransac_fit(m1, m2, valid, 0.05, n_iter, seed=seed, record=True)
        ref, rec_ref = ransac_fit_ref(m1, m2, valid, 0.05, n_iter, seed=seed)
        torch.cuda.synchronize()
        got = _ransac_against_plain(f"ransac{suffix}", fit, rec, ref, rec_ref, m1, m2, valid)
        require(int(fit.num_inliers) > 0.4 * N_TARGET, "ransac: no good model found")
        out.update({k + suffix: v for k, v in got.items()})
        out.update(paired_ms(
            lambda: ransac_homography(m1, m2, valid, 0.05, n_iter, generator=own),
            lambda: ransac_fit_ref(m1, m2, valid, 0.05, n_iter, seed=draw_seed(own, "cuda")),
            suffix=suffix))
        out["kernel_device_ms" + suffix] = device_ms(
            lambda: ransac_fit(m1, m2, valid, 0.05, n_iter, seed=seed))
        out.update(_ransac_bound(m1, m2, valid, seed, n_iter, suffix))
        out.update(library(None, suffix))
    out["max_abs_err"] = max(out["max_abs_err"], out["max_abs_err_50k"])
    return out


def check_ransac_adaptive(gen):
    """K4 at the loop's shape: 1200 matches, blocks of 4096, cap 50k; once
    with 60% inliers (one block) and once structureless (all 13 blocks),
    suffix `_to_cap`. The kernel's fit against the plain version's on the
    same seed; the kernel's call and the whole op run under sync-debug
    'error'; the whole op timed against the seed draw and the plain loop,
    its seeds drawn from a generator of this check's own (see
    check_ransac)."""
    from ransacflow_tpu_torch.kernels.ransac_adaptive import (
        ransac_adaptive, ransac_adaptive_ref)
    from ransacflow_tpu_torch.ops.ransac import draw_seed, ransac_homography_adaptive

    own = torch.Generator(device="cuda").manual_seed(MH_CHUNK)
    out = {"max_abs_err": 0.0}
    for case, frac, want_blocks in (("clean", 0.6, 1), ("structureless", 0.0, 13)):
        m1, m2, valid = _ransac_matches(gen, frac)
        seed = draw_seed(gen, "cuda")
        args = (m1, m2, valid, 0.05, MH_N_ITER, MH_CHUNK, 0.999)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fit, n_eval, rec = ransac_adaptive(*args, seed=seed, record=True)
            res, n_eval_op = ransac_homography_adaptive(m1, m2, valid, 0.05, MH_N_ITER,
                                                        MH_CHUNK, generator=gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ref, n_eval_r, rec_ref = ransac_adaptive_ref(*args, seed=seed)
        require(int(n_eval) == int(n_eval_r) == want_blocks * MH_CHUNK,
                f"ransac_adaptive ({case}): {int(n_eval)} evaluated, plain "
                f"{int(n_eval_r)}, expected {want_blocks} blocks")
        require(int(n_eval_op) == want_blocks * MH_CHUNK and bool(res.found),
                f"ransac_adaptive ({case}): op evaluated {int(n_eval_op)}")
        got = _ransac_against_plain(f"ransac_adaptive ({case})", fit, rec, ref, rec_ref, m1, m2,
                                    valid)
        out["max_abs_err"] = max(out["max_abs_err"], got.pop("max_abs_err"))
        suffix = "" if case == "clean" else "_to_cap"
        out.update({k + suffix: v for k, v in got.items()})
        out.update(paired_ms(
            lambda: ransac_homography_adaptive(m1, m2, valid, 0.05, MH_N_ITER, MH_CHUNK,
                                               generator=own),
            lambda: ransac_adaptive_ref(*args, seed=draw_seed(own, "cuda")),
            reps=5, suffix=suffix))
        out["kernel_device_ms" + suffix] = device_ms(lambda: ransac_adaptive(*args, seed=seed))
        # the blocks this run's data needs, not the cap
        out.update(_ransac_bound(m1, m2, valid, seed, want_blocks * MH_CHUNK, suffix))
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
    """K7: a fine pass's three epilogues in one launch, the flow's over
    (1, 60, 80, 49) logits and both sigmoids over (1, 60, 80, 1) maps, with
    match_down8 the two sigmoids bit for bit and the device kernels of one
    call (`kernels_per_call`); the training heads' two launches (suffix
    `_train`, (32, 28, 28, 49) and (.., 1)); and whether `nhwc` of conv4's
    output copies it on the card (`conv4_nhwc_copies`)."""
    from ransacflow_tpu_torch.kernels.heads import (
        flow_epilogue, flow_epilogue_ref, head_epilogues, head_epilogues_ref,
        match_epilogue, match_epilogue_ref)
    from ransacflow_tpu_torch.models.heads import Head
    from ransacflow_tpu_torch.models.layers import nchw, nhwc

    ins = [3 * torch.randn((1, 60, 80, c), generator=gen, device="cuda") for c in (49, 1, 1)]
    got, want = head_epilogues(*ins, 7), head_epilogues_ref(*ins, 7)
    torch.cuda.synchronize()
    errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
    require(errs[0] <= 1e-5 and max(errs[1:]) <= 1e-6,
            f"head_epilogues: max abs errs {errs} > 1e-5 (flow), 1e-6 (sigmoids)")
    require(torch.equal(got[3], torch.cat(got[1:3], dim=-1)),
            "head_epilogues: match_down8 is not (match12, match21)")
    # per flow logit: the max, exp, sum and two weighted sums (~7); a sigmoid ~4
    out = {"max_abs_err": max(errs), **paired_ms(lambda: head_epilogues(*ins, 7),
                                                 lambda: head_epilogues_ref(*ins, 7)),
           **bound(nbytes(*ins, *got), 7 * ins[0].numel() + 4 * 2 * ins[1].numel()),
           **library(None)}

    train = [3 * torch.randn((*TRAIN_FEAT, c), generator=gen, device="cuda") for c in (49, 1)]
    got = (flow_epilogue(train[0], 7), match_epilogue(train[1]))
    want = (flow_epilogue_ref(train[0], 7), match_epilogue_ref(train[1]))
    torch.cuda.synchronize()
    errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
    require(errs[0] <= 1e-5 and errs[1] <= 1e-6,
            f"head_epilogues_train: max abs errs {errs} > 1e-5 (flow), 1e-6 (sigmoid)")
    out["max_abs_err_train"] = max(errs)
    out.update(paired_ms(lambda: (flow_epilogue(train[0], 7), match_epilogue(train[1])),
                         lambda: (flow_epilogue_ref(train[0], 7), match_epilogue_ref(train[1])),
                         suffix="_train"))
    out.update(bound(nbytes(*train, *got), 7 * train[0].numel() + 4 * train[1].numel(),
                     "_train"))
    out.update(library(None, "_train"))
    # traced after the timings (a trace can slow the host's later launches)
    out["kernels_per_call"] = _kernels_per_call(lambda: head_epilogues(*ins, 7), "epilogue")
    require(out["kernels_per_call"] == 1,
            f"head_epilogues: {out['kernels_per_call']} device kernels a call, expected 1")

    head = Head(7, 49).cuda().eval()
    with torch.inference_mode():
        logits = head(nchw(torch.randn((1, 60, 80, 49), generator=gen, device="cuda")))
        out["conv4_nhwc_copies"] = nhwc(logits).data_ptr() != logits.data_ptr()
    return out


KITTI_COARSE_HW, KITTI_OUT_HW = (368, 1232), (375, 1242)  # fineSize grid, the GT's size


def check_compose_tail(gen):
    """K8 at 480x640 from the 60x80 maps, both cycle_match values, grids on
    the border included; across resolutions (suffix `_cross`), a 368x1232
    coarse grid composed at 375x1242 as KITTI's second pass does; and at
    480x640 with a residual large enough that most match21 corners leave
    the patch a block stages and are read from the map (suffix `_far`).
    Matchability is compared off the in-bounds step."""
    from ransacflow_tpu_torch.kernels.compose import compose_tail, compose_tail_ref

    out = {"max_abs_err": 0.0}
    cases = (("", TARGET_HW, None, 0.04), ("_cross", KITTI_COARSE_HW, KITTI_OUT_HW, 0.04),
             ("_far", TARGET_HW, None, 0.25))
    for suffix, coarse_hw, out_hw, residual in cases:
        h8, w8 = coarse_hw[0] // 8, coarse_hw[1] // 8
        flow8 = residual * torch.randn((1, h8, w8, 2), generator=gen, device="cuda")
        m12 = torch.rand((1, h8, w8, 1), generator=gen, device="cuda")
        m21 = torch.rand((1, h8, w8, 1), generator=gen, device="cuda")
        for warped in (False, True):
            coarse = _homography_grid(*coarse_hw, warped)
            for cycle in (False, True):
                flow, match = compose_tail(flow8, m12, m21, coarse, cycle, out_hw)
                flow_r, match_r = compose_tail_ref(flow8, m12, m21, coarse, cycle, out_hw)
                torch.cuda.synchronize()
                require(flow.shape == flow_r.shape and match.shape == match_r.shape,
                        f"compose_tail{suffix}: shapes {flow.shape} {flow_r.shape}")
                off = ((flow_r.abs() - 1).abs() > 1e-5).all(dim=-1)
                err = max((flow - flow_r).abs().max().item(),
                          (match - match_r)[off].abs().max().item())
                require(err <= 1e-5, f"compose_tail{suffix} (cycle {cycle}): max abs err {err}")
                out["max_abs_err"] = max(out["max_abs_err"], err)
        for cycle, c_suffix in ((False, ""), (True, "_cycle")):
            out.update(paired_ms(lambda: compose_tail(flow8, m12, m21, coarse, cycle, out_hw),
                                 lambda: compose_tail_ref(flow8, m12, m21, coarse, cycle, out_hw),
                                 suffix=suffix + c_suffix))
        # per output pixel: three 4-tap upsamplings, the grid sample (~60)
        out.update(bound(nbytes(flow8, m12, m21, coarse, flow, match), 60 * match.numel(),
                         suffix))
        out.update(library(None, suffix))
    # traced after the timings (a trace can slow the host's later launches)
    out["kernels_per_call"] = _kernels_per_call(
        lambda: compose_tail(flow8, m12, m21, coarse, True), "compose_kernel")
    require(out["kernels_per_call"] == 1,
            f"compose_tail: {out['kernels_per_call']} device kernels a call, expected 1")
    return out


TRAIN_PAIRS, TRAIN_IMG, TRAIN_MARGIN = 16, 224, 88  # the reference's stage presets
TRAIN_FEAT = (2 * TRAIN_PAIRS, TRAIN_IMG // 8, TRAIN_IMG // 8)  # (32, 28, 28)


def _grads(out, inputs, g):
    """Backward of `out` alone (the graph kept), for timing it."""
    return lambda: torch.autograd.grad(out, inputs, g, retain_graph=True)


def _backward_check(name, kernel_fn, plain_fn, inputs, tol, gen, suffix=""):
    """Forward and backward of `kernel_fn` against `plain_fn` on `inputs`
    (each requiring grad): max errors and paired times of the backward.
    Each input's cotangent is held to `tol` times the larger of 1 and the
    plain one's largest magnitude (fp32 rounding grows with the values).
    The output's cotangent comes in the memory format of the kernel's
    output, as the training step hands it back (K9's channels-last)."""
    ks = [x.detach().clone().requires_grad_() for x in inputs]
    ps = [x.detach().clone().requires_grad_() for x in inputs]
    out_k, out_p = kernel_fn(*ks), plain_fn(*ps)
    g = torch.empty_like(out_k).normal_(generator=gen)
    d_k = torch.autograd.grad(out_k, ks, g, retain_graph=True)
    d_p = torch.autograd.grad(out_p, ps, g, retain_graph=True)
    torch.cuda.synchronize()
    require(out_k.grad_fn is not None, f"{name}: the kernel's output has no grad_fn")
    errs = [(a - b).abs().max().item() for a, b in zip(d_k, d_p)]
    scales = [max(1.0, b.abs().max().item()) for b in d_p]
    for e, s in zip(errs, scales):
        require(e <= tol * s, f"{name}: backward max abs err {e} > {tol} * {s}")
    return {"max_abs_err": max(errs), "grad_scale": max(scales),
            **paired_ms(_grads(out_k, ks, g), _grads(out_p, ps, g), suffix=suffix)}


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


# K9's three calls in a training step, channels-last as the feature
# extractor hands them over: the stem (after conv1 and the 2x2 max-pool),
# layer2.0.downsample and layer3.0.downsample (models/feature_extractor.py)
K9_CALLS = (("", 64, TRAIN_IMG - 1), ("_layer2", 64, TRAIN_IMG // 2),
            ("_layer3", 128, TRAIN_IMG // 4))


def check_blur_pool(gen):
    """K9 forward and backward at the training step's three calls, batch 32.
    The rows' own keys are the stem's; the others carry their suffix. The
    library call is reflect pad + grouped `F.conv2d` (cuDNN's depthwise
    convolution), and for the backward its autograd."""
    import torch.nn.functional as F

    from ransacflow_tpu_torch.kernels.blurpool import binomial_filter, blur_pool, blur_pool_ref

    fwd, bwd = {"max_abs_err": 0.0}, {"max_abs_err": 0.0, "grad_scale": 0.0}
    for suffix, c, hw in K9_CALLS:
        x = torch.rand((TRAIN_FEAT[0], c, hw, hw), generator=gen,
                       device="cuda").contiguous(memory_format=torch.channels_last)
        filt = binomial_filter(c, 3, "cuda")
        lib = lambda a: F.conv2d(F.pad(a, (1, 1, 1, 1), mode="reflect"),  # noqa: E731
                                 filt, stride=2, groups=c)
        y = blur_pool(x, filt)
        err = (y - blur_pool_ref(x, filt)).abs().max().item()
        require(err <= 1e-6, f"blur_pool{suffix}: max abs err {err} > 1e-6")  # 9 exact taps
        fwd["max_abs_err"] = max(fwd["max_abs_err"], err)
        fwd.update(paired_ms(lambda: blur_pool(x, filt), lambda: blur_pool_ref(x, filt),
                             suffix=suffix))
        fwd.update(bound(nbytes(x, y), 18 * y.numel(), suffix))
        fwd.update(library(lambda: lib(x), suffix))
        got = _backward_check("blur_pool_bwd" + suffix, lambda a: blur_pool(a, filt),
                              lambda a: blur_pool_ref(a, filt), [x], 1e-5, gen, suffix)
        bwd["max_abs_err"] = max(bwd["max_abs_err"], got.pop("max_abs_err"))
        bwd["grad_scale"] = max(bwd["grad_scale"], got.pop("grad_scale"))
        bwd.update(got)
        # the output's cotangent read, the input's written; 9 taps each
        bwd.update(bound(nbytes(y, x), 18 * y.numel(), suffix))
        x_lib = x.detach().clone().requires_grad_()
        y_lib = lib(x_lib)
        bwd.update(library(_grads(y_lib, [x_lib], torch.randn_like(y_lib)), suffix))
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


def _kernels_per_call(fn, key, reps=3):
    """Device kernels whose name holds `key` per call of fn, from a profiler
    trace (a spin kernel first: a session may miss its first launches; the
    largest of three traces, since a trace can miss launches but never adds
    them)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    most = 0.0
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(100000)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        most = max(most, sum(e.count for e in prof.key_averages()
                             if key in e.key and e.self_device_time_total > 0) / reps)
    return most


def _ssim_case(masked_ssim_loss, masked_ssim_loss_ref, img1, img2, match, name):
    """Both forwards (img1 without and with grad) and the backward against
    the plain version: the loss to 1e-5 relative, the gradient to 1e-4 of
    its largest magnitude; each deterministic bit for bit. Returns (the
    forwards' relative error, the gradient's max abs error, its scale, the
    grad-requiring img1 and its loss)."""
    ref_i = img1.clone().requires_grad_()
    ref = masked_ssim_loss_ref(ref_i, img2, match)
    i_k = img1.clone().requires_grad_()
    loss, loss_grad = masked_ssim_loss(img1, img2, match), masked_ssim_loss(i_k, img2, match)
    rel = max(abs(x.item() - ref.item()) / abs(ref.item()) for x in (loss, loss_grad))
    require(rel <= 1e-5, f"masked_ssim{name}: relative err {rel} > 1e-5")
    require(loss.item() == masked_ssim_loss(img1, img2, match).item()
            and loss_grad.item() == masked_ssim_loss(i_k, img2, match).item(),
            f"masked_ssim{name}: two calls differ (the reduction must be deterministic)")
    one = torch.ones((), device="cuda")
    d_k = torch.autograd.grad(loss_grad, i_k, one, retain_graph=True)[0]
    d_k2 = torch.autograd.grad(loss_grad, i_k, one, retain_graph=True)[0]
    d_p = torch.autograd.grad(ref, ref_i, one)[0]
    require(torch.equal(d_k, d_k2), f"masked_ssim_bwd{name}: two backward calls differ")
    scale = d_p.abs().max().item()
    err = (d_k - d_p).abs().max().item()
    require(err <= 1e-4 * scale, f"masked_ssim_bwd{name}: max abs err {err} > 1e-4 * {scale}")
    return rel, err, scale, i_k, loss_grad


def check_masked_ssim(gen):
    """K10 at the training shape: (32, 224, 224, 3), the mask from a
    matchability that is zero outside the 48x48 supervised centre; the
    forward timed with img1 not requiring grad (keys without suffix) and
    requiring it (`_grad`: the per-pixel partials written, the training
    step's call). Then a width that is not a multiple of 4 (2, 37, 70) and
    an image smaller than the halo (1, 7, 9), each checked, not timed."""
    from ransacflow_tpu_torch.kernels.ssim import (
        N_PLANES, masked_ssim_loss, masked_ssim_loss_ref)

    b2 = TRAIN_FEAT[0]
    img1 = torch.rand((b2, TRAIN_IMG, TRAIN_IMG, 3), generator=gen, device="cuda")
    img2 = (img1 + 0.1 * torch.rand(img1.shape, generator=gen, device="cuda")).clamp(0, 1)
    match = torch.zeros((b2, TRAIN_IMG, TRAIN_IMG, 1), device="cuda")
    c = slice(TRAIN_MARGIN, TRAIN_IMG - TRAIN_MARGIN)
    match[:, c, c] = torch.rand(match[:, c, c].shape, generator=gen, device="cuda")
    rel, err, scale, i_k, l_k = _ssim_case(masked_ssim_loss, masked_ssim_loss_ref,
                                           img1, img2, match, "")
    i_p = img1.clone().requires_grad_()
    l_p = masked_ssim_loss_ref(i_p, img2, match)
    small = {}
    for shape in ((2, 37, 70), (1, 7, 9)):
        s1 = torch.rand((*shape, 3), generator=gen, device="cuda")
        s2 = (s1 + 0.1 * torch.rand(s1.shape, generator=gen, device="cuda")).clamp(0, 1)
        sm = torch.rand((*shape, 1), generator=gen, device="cuda")
        key = f"_{shape[1]}x{shape[2]}"
        s_rel, s_err, s_scale, _, _ = _ssim_case(masked_ssim_loss, masked_ssim_loss_ref,
                                                 s1, s2, sm, key)
        small.update({"rel_err" + key: s_rel, "bwd_max_abs_err" + key: s_err,
                      "bwd_grad_scale" + key: s_scale})
    # per pixel and channel: five separable 11-tap blurs (220) and the SSIM
    # map (~25); per pixel the separable box of the mask (44)
    fwd_bytes, partials_bytes = nbytes(img1, img2, match, l_k), N_PLANES * match.numel() * 4
    fwd_ops = 245 * img1.numel() + 44 * match.numel()
    fwd = {"max_abs_err": abs(l_k.item() - l_p.item()), "rel_err": rel,
           **paired_ms(lambda: masked_ssim_loss(img1, img2, match),
                       lambda: masked_ssim_loss_ref(img1, img2, match)),
           **paired_ms(lambda: masked_ssim_loss(i_k, img2, match),
                       lambda: masked_ssim_loss_ref(i_p, img2, match), suffix="_grad"),
           **bound(fwd_bytes, fwd_ops), **bound(fwd_bytes, fwd_ops, "_grad"),
           # the design's byte floors: what it moves (with the partials written)
           "floor_ms": fwd_bytes / HBM_BYTES_PER_S * 1e3,
           "floor_ms_grad": (fwd_bytes + partials_bytes) / HBM_BYTES_PER_S * 1e3,
           **small, **library(None)}
    one = torch.ones((), device="cuda")
    # the forward's maps, three partials blurred again (132) and the sum (~15)
    bwd = {"max_abs_err": err, "grad_scale": scale,
           **paired_ms(_grads(l_k, i_k, one), _grads(l_p, i_p, one)),
           **bound(nbytes(img1, img2, match, img1), 392 * img1.numel() + 44 * match.numel()),
           "floor_ms": (partials_bytes + nbytes(img1, img2, img1)) / HBM_BYTES_PER_S * 1e3,
           **library(None)}
    # device kernels per call, traced after the timings (a trace can slow
    # the host's later launches)
    fwd["kernels_per_call"] = _kernels_per_call(lambda: masked_ssim_loss(img1, img2, match),
                                                "ssim_")
    fwd["kernels_per_call_grad"] = _kernels_per_call(
        lambda: masked_ssim_loss(i_k, img2, match), "ssim_")
    bwd["kernels_per_call"] = _kernels_per_call(_grads(l_k, i_k, one), "ssim_")
    require(0 < fwd["kernels_per_call"] <= 2 and 0 < fwd["kernels_per_call_grad"] <= 2,
            f"masked_ssim: device kernels per call {fwd['kernels_per_call']}, "
            f"{fwd['kernels_per_call_grad']} (at most 2)")
    require(0 < bwd["kernels_per_call"] <= 1,
            f"masked_ssim_bwd: device kernels per call {bwd['kernels_per_call']} (at most 1)")
    return fwd, bwd


def _resample_ops(pairs):
    """A multiply-add per tap and channel for each resampled (in, out) grid
    pair, and the normalization (3 per element) for every out grid."""
    from ransacflow_tpu_torch.kernels.anchor_resample import bilinear_weights
    from ransacflow_tpu_torch.kernels.pyramid import taps

    ops = 0
    for (h, w), (fh, fw) in pairs:
        if (h, w) != (fh, fw):
            ops += 2 * N_CHANNELS * (int(taps(h, fh, bilinear_weights)[1].sum())
                                     * int(taps(w, fw, bilinear_weights)[1].sum()))
        ops += 3 * N_CHANNELS * fh * fw
    return ops


def check_anchor_resample(gen):
    """K12 at a serving pair's four resamples (anchors 0, 3, 6 of the 7-scale
    pyramid), 1024 channels, as one call of four scales (the keys without
    suffix, the four resamples timed before the bank form existed); then,
    suffix `_bank`, the whole bank of a serving pair at anchor stride 3 as
    `pipeline.bank.anchor_bank` builds it: 7 scales, the anchors' identity
    rows included, one launch."""
    import torch.nn.functional as F

    from ransacflow_tpu_torch.kernels.anchor_resample import (
        anchor_resample_bank, anchor_resample_bank_ref)
    from ransacflow_tpu_torch.pipeline.bank import nearest_anchors
    from ransacflow_tpu_torch.utils.image import pyramid_shapes

    def lib(maps, grids):  # F.interpolate agrees with JAX's resize (tests/test_torch_fastmodes.py)
        return [F.normalize(fmap.permute(0, 3, 1, 2) if fmap.shape[1:3] == grid else
                            F.interpolate(fmap.permute(0, 3, 1, 2), size=grid, mode="bilinear",
                                          align_corners=False, antialias=True), dim=1)
                for fmap, grid in zip(maps, grids)]

    shapes = pyramid_shapes()
    nearest = nearest_anchors(shapes, 3)
    anchors = {i: 3 * torch.randn((1, h // 16, w // 16, N_CHANNELS), generator=gen,
                                  device="cuda")
               for i, (h, w) in enumerate(shapes) if i in nearest}
    out = {}
    for suffix, scales in (("", [j for j, i in enumerate(nearest) if i != j]),
                           ("_bank", list(range(len(shapes))))):
        maps = {k: anchors[nearest[j]] for k, j in enumerate(scales)}
        sub = [shapes[j] for j in scales]
        order = list(range(len(scales)))
        grids = [(h // 16, w // 16) for h, w in sub]
        bank = torch.empty((1, sum(h * w for h, w in grids), N_CHANNELS), device="cuda")
        kernel = lambda: anchor_resample_bank(maps, sub, order, out=bank)  # noqa: E731
        plain = lambda: anchor_resample_bank_ref(maps, sub, order)  # noqa: E731
        err = (kernel() - plain()).abs().max().item()
        torch.cuda.synchronize()
        # unit rows from fp32 sums of <= 9 taps in another order
        require(err <= 1e-5, f"anchor_resample{suffix}: max abs err {err} > 1e-5")
        inputs = list({id(m): m for m in maps.values()}.values())  # each map read once
        pairs = [(tuple(maps[k].shape[1:3]), grid) for k, grid in enumerate(grids)]
        out.update({"max_abs_err" + suffix: err, "scales" + suffix: len(scales),
                    **paired_ms(kernel, plain, suffix=suffix),
                    **bound(nbytes(*inputs, bank), _resample_ops(pairs), suffix),
                    **library(lambda: lib(list(maps.values()), grids), suffix)})
    return out


# -- the batch forms (K2, K3, K4, K12, and K5h at B = 4) ----------------------
BATCH_KS = (2, 4)  # pairs of the batch forms' checks


def _same_bits(a, b):
    """Equal tensors, floats compared by their bits (a NaN equals a NaN)."""
    if a.is_floating_point():
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _batch_singles(name, batch_outs, single_outs):
    """A batch form's outputs (leading pair axis) against its single form's,
    pair by pair, bit for bit."""
    for p, one in enumerate(single_outs):
        for i, (b, s) in enumerate(zip(batch_outs, one)):
            require(_same_bits(b[p], s), f"{name}: output {i} of pair {p} differs from the "
                                         "single launch's")


def check_matching_batch(gen):
    """K2 on k serving scores at once (13065 x 1200 each, fresh features a
    pair), exact (`_batch<k>`), relax_cells 1 on the 30 x 40 grid
    (`_relaxed_batch<k>`) and with a (k, 1200) mask (`_masked_batch<k>`):
    every output bit for bit its plain twin's and each pair's own launch's;
    `singles_ms` the k launches of one pair each."""
    from ransacflow_tpu_torch.kernels.matching import mutual_argmax, mutual_argmax_ref

    out = {}
    for k in BATCH_KS:
        feat_a = _normalized((k, N_CHANNELS, N_BANK), 1, gen)
        feat_b = _normalized((k, N_CHANNELS, N_TARGET), 1, gen)
        score = torch.bmm(feat_a.transpose(1, 2), feat_b)
        valid_b = torch.rand((k, N_TARGET), generator=gen, device="cuda") > 0.1
        for case, args in (("", (score, 0, None, None)), ("_relaxed", (score, 1, 40, None)),
                           ("_masked", (score, 0, None, valid_b))):
            suffix = f"{case}_batch{k}"
            got = mutual_argmax(*args)
            want = mutual_argmax_ref(*args)
            torch.cuda.synchronize()
            for name, g, w in zip(("best_src", "best_tgt", "valid", "pair_score"), got, want):
                require(_same_bits(g, w), f"matching{suffix}: {name} differs from the twin")
            _batch_singles(f"matching{suffix}", got, [
                mutual_argmax(score[p], *args[1:3], None if args[3] is None else args[3][p])
                for p in range(k)])
            out["max_abs_err" + suffix] = (got[3] - want[3]).abs().max().item()
            out["n_valid" + suffix] = int(got[2].sum())
            out.update(paired_ms(lambda: mutual_argmax(*args),
                                 lambda: mutual_argmax_ref(*args), suffix=suffix,
                                 plain_reps=5))
            out["singles_ms" + suffix] = cuda_ms(lambda: [
                mutual_argmax(score[p], *args[1:3], None if args[3] is None else args[3][p])
                for p in range(k)])
            out.update(bound(nbytes(*[a for a in args if isinstance(a, torch.Tensor)], *got),
                             2 * score.numel(), suffix))
    return out


def check_anchor_resample_batch(gen):
    """K12 on k serving pairs' 7-scale banks at anchor stride 3 in one launch
    (`_bank_batch<k>`), within 1e-5 of the plain twin and each bank bit for
    bit its own pair's launch's."""
    from ransacflow_tpu_torch.kernels.anchor_resample import (
        anchor_resample_bank, anchor_resample_bank_ref)
    from ransacflow_tpu_torch.pipeline.bank import nearest_anchors
    from ransacflow_tpu_torch.utils.image import pyramid_shapes

    shapes = pyramid_shapes()
    nearest = nearest_anchors(shapes, 3)
    grids = [(h // 16, w // 16) for h, w in shapes]
    out = {}
    for k in BATCH_KS:
        suffix = f"_bank_batch{k}"
        maps = {i: 3 * torch.randn((k, h // 16, w // 16, N_CHANNELS), generator=gen,
                                   device="cuda")
                for i, (h, w) in enumerate(shapes) if i in nearest}
        bank = anchor_resample_bank(maps, shapes, nearest)
        err = (bank - anchor_resample_bank_ref(maps, shapes, nearest)).abs().max().item()
        torch.cuda.synchronize()
        require(err <= 1e-5, f"anchor_resample{suffix}: max abs err {err} > 1e-5")

        def singles():
            return [anchor_resample_bank({i: m[p:p + 1] for i, m in maps.items()}, shapes,
                                         nearest) for p in range(k)]

        _batch_singles(f"anchor_resample{suffix}", (bank,), [(b[0],) for b in singles()])
        pairs = [(tuple(maps[i].shape[1:3]), grid) for i, grid in zip(nearest, grids)]
        out.update({"max_abs_err" + suffix: err,
                    **paired_ms(lambda: anchor_resample_bank(maps, shapes, nearest),
                                lambda: anchor_resample_bank_ref(maps, shapes, nearest),
                                suffix=suffix, plain_reps=3),
                    "singles_ms" + suffix: cuda_ms(singles),
                    **bound(nbytes(*maps.values(), bank), k * _resample_ops(pairs), suffix)})
    return out


def _ransac_batch_problems(gen, fracs):
    """k serving match sets (`_ransac_matches`, 1200 cells) with the given
    inlier fractions, stacked, and k seeds."""
    from ransacflow_tpu_torch.ops.ransac import draw_seed

    sets = [_ransac_matches(gen, f) for f in fracs]
    m1, m2, valid = (torch.stack(x).contiguous() for x in zip(*sets))
    return m1, m2, valid, torch.cat([draw_seed(gen, "cuda") for _ in fracs])


def _ransac_batch_bound(m1, m2, valid, seeds, n_hyps, suffix):
    b = o = 0
    for p, n_hyp in enumerate(n_hyps):
        r = _ransac_bound(m1[p], m2[p], valid[p], seeds[p:p + 1], n_hyp)
        b, o = b + r["bound_bytes"], o + r["bound_ops"]
    return bound(b, o, suffix)


def _ransac_batch_against(name, fit, rec, ref, rec_ref, singles, m1, m2, valid, rows=None):
    """Each pair of k RANSAC fits in one launch against its plain twin's
    (`_ransac_against_plain`, on the rows the pair evaluated) and bit for
    bit against its own launch's fit and record."""
    from ransacflow_tpu_torch.kernels.ransac import Record, pair_of

    err, agree = 0.0, 1.0
    for p, (one, one_rec) in enumerate(singles):
        n = rec.counts.shape[1] if rows is None else rows[p]
        got = _ransac_against_plain(
            f"{name} pair {p}", pair_of(fit, p), Record(rec.counts[p, :n], rec.sets[p, :n]),
            pair_of(ref, p), Record(rec_ref.counts[p, :n], rec_ref.sets[p, :n]),
            m1[p], m2[p], valid[p])
        err, agree = max(err, got["max_abs_err"]), min(agree, got["counts_agree"])
        for i, (b, s) in enumerate(zip(pair_of(fit, p), one)):
            require(_same_bits(b, s), f"{name}: result field {i} of pair {p} differs from "
                                      "the single launch's")
        require(torch.equal(rec.counts[p, :n], one_rec.counts[:n])
                and torch.equal(rec.sets[p, :n], one_rec.sets[:n]),
                f"{name}: pair {p}'s record differs from the single launch's")
    return err, agree


def check_ransac_batch(gen):
    """K3 on k serving fits (1200 matches, 10k hypotheses, 60% inliers, a
    seed each) in one launch (`_batch<k>`), each pair against the plain twin
    as K3 is, and bit for bit its own launch's."""
    from ransacflow_tpu_torch.kernels.ransac import ransac_fit, ransac_fit_ref

    out = {}
    for k in BATCH_KS:
        suffix = f"_batch{k}"
        m1, m2, valid, seeds = _ransac_batch_problems(gen, [0.6] * k)
        args = (m1, m2, valid, 0.05, N_ITER)
        fit, rec = ransac_fit(*args, seed=seeds, record=True)
        ref, rec_ref = ransac_fit_ref(*args, seed=seeds)
        singles = [ransac_fit(m1[p], m2[p], valid[p], 0.05, N_ITER, seed=seeds[p:p + 1],
                              record=True) for p in range(k)]
        torch.cuda.synchronize()
        err, agree = _ransac_batch_against(f"ransac{suffix}", fit, rec, ref, rec_ref, singles,
                                           m1, m2, valid)
        out.update({"max_abs_err" + suffix: err, "counts_agree" + suffix: agree,
                    **paired_ms(lambda: ransac_fit(*args, seed=seeds),
                                lambda: ransac_fit_ref(*args, seed=seeds), suffix=suffix,
                                plain_reps=2),
                    "singles_ms" + suffix: cuda_ms(lambda: [
                        ransac_fit(m1[p], m2[p], valid[p], 0.05, N_ITER, seed=seeds[p:p + 1])
                        for p in range(k)]),
                    **_ransac_batch_bound(m1, m2, valid, seeds, [N_ITER] * k, suffix)})
    return out


def check_adaptive_batch(gen):
    """K4 on k fits in one cooperative launch, under sync-debug 'error':
    k fits of 1200 matches in blocks of 4096 to the 50k cap, all
    structureless (every pair to the cap, `_to_cap_batch4`) and with inlier
    fractions that stop the pairs after different blocks (`_stops_batch2`,
    `_stops_batch4`); each pair evaluates the blocks its plain twin does,
    agrees with it as K4 does and is bit for bit its own launch."""
    from ransacflow_tpu_torch.kernels.ransac_adaptive import (
        ransac_adaptive, ransac_adaptive_ref)

    out = {}
    # w = 0.6 stops after one block, 0.15 and 0.12 after about 4 and 9 (n_req =
    # log(0.001) / log(1 - w^4)), 0 runs to the cap
    cases = ((2, "_stops", [0.6, 0.0]), (4, "_to_cap", [0.0] * 4),
             (4, "_stops", [0.6, 0.0, 0.15, 0.12]))
    for k, case, fracs in cases:
        suffix = f"{case}_batch{k}"
        m1, m2, valid, seeds = _ransac_batch_problems(gen, fracs)
        args = (m1, m2, valid, 0.05, MH_N_ITER, MH_CHUNK, 0.999)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fit, n_eval, rec = ransac_adaptive(*args, seed=seeds, record=True)
            singles = [ransac_adaptive(m1[p], m2[p], valid[p], *args[3:],
                                       seed=seeds[p:p + 1], record=True)
                       for p in range(k)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ref, n_eval_r, rec_ref = ransac_adaptive_ref(*args, seed=seeds)
        require(torch.equal(n_eval.cpu(), n_eval_r.cpu())
                and all(int(s[1]) == int(n) for s, n in zip(singles, n_eval)),
                f"ransac_adaptive{suffix}: evaluated {n_eval.tolist()}, plain "
                f"{n_eval_r.tolist()}, singles {[int(s[1]) for s in singles]}")
        if case == "_to_cap":
            require(set(n_eval.tolist()) == {-(-MH_N_ITER // MH_CHUNK) * MH_CHUNK},
                    f"ransac_adaptive{suffix}: not every pair ran to the cap: "
                    f"{n_eval.tolist()}")
        else:
            require(len(set(n_eval.tolist())) > 1,
                    f"ransac_adaptive{suffix}: the pairs stopped together: "
                    f"{n_eval.tolist()}")
        rows = [int(n) for n in n_eval]
        err, agree = _ransac_batch_against(
            f"ransac_adaptive{suffix}", fit, rec, ref, rec_ref,
            [(s[0], s[2]) for s in singles], m1, m2, valid, rows)
        out.update({"max_abs_err" + suffix: err, "counts_agree" + suffix: agree,
                    "evaluated" + suffix: rows,
                    **paired_ms(lambda: ransac_adaptive(*args, seed=seeds),
                                lambda: ransac_adaptive_ref(*args, seed=seeds),
                                reps=5, suffix=suffix, plain_reps=1),
                    "singles_ms" + suffix: cuda_ms(lambda: [
                        ransac_adaptive(m1[p], m2[p], valid[p], *args[3:],
                                        seed=seeds[p:p + 1]) for p in range(k)], reps=5),
                    **_ransac_batch_bound(m1, m2, valid, seeds, rows, suffix)})
    return out


def check_warp_homography_batch(gen):
    """K5's homography form at B = 4 (`_b4`): four 480x640 sources, each
    warped by its own homography (the identity among them) as the batched
    fine stage calls it, against its plain version."""
    from ransacflow_tpu_torch.kernels.warp_sample import warp_homography, warp_homography_ref

    src = torch.rand((4, *TARGET_HW, 3), generator=gen, device="cuda")
    H = (torch.eye(3, device="cuda")
         + 0.03 * torch.randn((4, 3, 3), generator=gen, device="cuda")).contiguous()
    H[0] = torch.eye(3, device="cuda")
    img, grid = warp_homography(src, H, TARGET_HW)
    img_r, grid_r = warp_homography_ref(src, H, TARGET_HW)
    torch.cuda.synchronize()
    err, grid_err = (img - img_r).abs().max().item(), (grid - grid_r).abs().max().item()
    require(err <= 1e-5 and grid_err <= 1e-6,
            f"warp_homography_b4: image err {err} > 1e-5 or grid err {grid_err} > 1e-6")
    return {"max_abs_err_b4": err, "grid_max_abs_err_b4": grid_err,
            **paired_ms(lambda: warp_homography(src, H, TARGET_HW),
                        lambda: warp_homography_ref(src, H, TARGET_HW), suffix="_b4"),
            **bound(nbytes(src, H, img, grid), img.numel() // 3 * (22 + 8 * 3), "_b4")}


BATCH_CHECKS = (("mutual_argmax", check_matching_batch), ("ransac_score", check_ransac_batch),
                ("ransac_adaptive", check_adaptive_batch),
                ("anchor_resample", check_anchor_resample_batch),
                ("warp_homography", check_warp_homography_batch))


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
    # traced after the timings: the segment cells' sums, then the bins
    out["kernels_per_call"] = _kernels_per_call(lambda: ppm_pool(x, scales), "ppm_")
    require(out["kernels_per_call"] == 2,
            f"ppm_pool: {out['kernels_per_call']} device kernels a call, expected 2")
    return out


# K14's calls at the trunk's shapes, one picture: (suffix, C, H, W, shortcut):
# layer1's conv3 at the pyramid's 960x1280 scale (with the shortcut) and its
# conv1 (without), layer3's conv3 at the 240x320 scale and its conv1
K14_CALLS = (("", 256, 240, 320, True), ("_layer1_conv1", 64, 240, 320, False),
             ("_layer3", 1024, 15, 20, True), ("_layer3_conv1", 256, 15, 20, False))


def _trunk_fold_gaps(gen):
    """The frozen trunk (BatchNorm folded, K14) against the unfolded one at
    the serving pyramid's shapes and the target's, one picture each, its
    BatchNorm off the identity: max abs gap and the gap over the largest
    feature; K14's launches a pass."""
    from ransacflow_tpu_torch import kernels
    from ransacflow_tpu_torch.models.convert import init_resnet50_layer3
    from ransacflow_tpu_torch.models.resnet50 import resnet50_layer3
    from ransacflow_tpu_torch.utils.image import pyramid_shapes

    net = init_resnet50_layer3(torch.Generator().manual_seed(0), "cuda")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.75 + 0.5 * torch.rand(c, generator=g))
                m.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
    out = {"trunk_gap_max_abs": 0.0, "trunk_gap_rel": 0.0}
    for h, w in list(pyramid_shapes()) + [TARGET_HW]:
        x = torch.rand((1, h, w, 3), generator=gen, device="cuda")
        with torch.enable_grad():
            want = resnet50_layer3(net, x).detach()
        kernels.reset_launch_counts()
        with torch.inference_mode():
            got = resnet50_layer3(net, x)
        torch.cuda.synchronize()
        n = kernels.launch_counts()["conv_epilogue"]
        require(n == 40, f"frozen trunk at {h}x{w}: {n} conv_epilogue launches, expected 40")
        gap = (got - want).abs().max().item()
        out["trunk_gap_max_abs"] = max(out["trunk_gap_max_abs"], gap)
        out["trunk_gap_rel"] = max(out["trunk_gap_rel"], gap / want.abs().max().item())
    require(out["trunk_gap_rel"] <= 1e-5,
            f"frozen trunk: gap {out['trunk_gap_rel']} of the largest feature > 1e-5")
    return out


def check_conv_epilogue(gen):
    """K14 at the trunk's shapes (`K14_CALLS`) against its plain version bit
    for bit, in place; bound: the output read and written once, the
    shortcut read once. The timed calls rotate over copies that together
    hold ~200 MB, 4x the L2 cache, so that each call reads device memory
    (one buffer written in place call after call would stay in L2 at
    layer1's 79 MB and below). No one PyTorch call computes it (bias, add
    and ReLU are three). Then the frozen trunk against the unfolded one
    (`_trunk_fold_gaps`)."""
    import itertools

    from ransacflow_tpu_torch.kernels.conv_epilogue import conv_epilogue, conv_epilogue_ref

    out = {"max_abs_err": 0.0}
    for suffix, c, h, w, shortcut in K14_CALLS:
        x = torch.randn((1, c, h, w), generator=gen, device="cuda")
        bias = torch.randn((c,), generator=gen, device="cuda")
        res = torch.randn((1, c, h, w), generator=gen, device="cuda") if shortcut else None
        got = conv_epilogue(x.clone(), bias, res)
        want = conv_epilogue_ref(x.clone(), bias, res)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"conv_epilogue{suffix}: not the plain version's bits")
        n_buf = max(2, -(-200_000_000 // nbytes(x)))
        ys = [x.clone() for _ in range(n_buf)]
        rs = [res.clone() for _ in range(n_buf)] if shortcut else [None] * n_buf
        turn = itertools.cycle(range(n_buf))

        def rotated(fn):
            def call():
                i = next(turn)
                return fn(ys[i], bias, rs[i])
            return call

        out.update(paired_ms(rotated(conv_epilogue), rotated(conv_epilogue_ref),
                             suffix=suffix))
        out.update(bound(nbytes(x, x) + (nbytes(res) if shortcut else 0), 0, suffix))
        out.update(library(None, suffix))
    out.update(_trunk_fold_gaps(gen))
    return out


# K15's calls, the fine stage's convolutions at the alignment cells' shapes:
# (name, Cin, Cout, kernel, stride, input H, W, epilogue), once at batch 32
# and once at batch 1; a fine pass runs the extractor's rows over the target
# and the warped source, the heads' over its three trunks (layer1's conv1
# has the shape of its conv2 without the shortcut, and so on)
K15_CALLS = (("stem", 3, 64, 3, 1, 480, 640, "relu"),
             ("layer1", 64, 64, 3, 1, 240, 320, "shortcut"),
             ("layer2_conv1", 64, 128, 3, 2, 240, 320, "relu"),
             ("layer2_down", 64, 128, 1, 1, 120, 160, "none"),
             ("layer2", 128, 128, 3, 1, 120, 160, "shortcut"),
             ("layer3_conv1", 128, 256, 3, 2, 120, 160, "relu"),
             ("layer3_down", 128, 256, 1, 1, 60, 80, "none"),
             ("layer3", 256, 256, 3, 1, 60, 80, "shortcut"),
             ("head_conv1", 49, 512, 3, 1, 60, 80, "relu"),
             ("head_conv2", 512, 256, 3, 1, 60, 80, "relu"),
             ("head_conv3", 256, 128, 3, 1, 60, 80, "relu"),
             ("flow_conv4", 128, 49, 3, 1, 60, 80, "none"),
             ("match_conv4", 128, 1, 3, 1, 60, 80, "none"))
K15_BATCHES = (32, 1)
K15_RTOL = 2e-5  # of the largest output: fp32 sums in another order


def _fine_pass(align, src, tgt, h21, frozen):
    """A fine pass (`pipeline/fine._after_warp` at the homography warp) with
    its networks frozen (folded, kernel 15) or unfolded (cuDNN, under
    grad, their outputs detached); the kernels between them as on the
    path."""
    from ransacflow_tpu_torch.kernels.compose import compose_tail
    from ransacflow_tpu_torch.kernels.correlation import correlation_pair
    from ransacflow_tpu_torch.kernels.heads import head_epilogues
    from ransacflow_tpu_torch.kernels.warp_sample import warp_homography
    from ransacflow_tpu_torch.models.feature_extractor import feature_extractor
    from ransacflow_tpu_torch.models.heads import head_logits
    from ransacflow_tpu_torch.models.layers import l2_normalize

    def net(fn):
        if frozen:
            with torch.inference_mode():
                return fn()
        with torch.enable_grad():
            return fn().detach()

    with torch.no_grad():  # not inference tensors: the unfolded nets run under grad
        src_warp, grid = warp_homography(src, h21, tgt.shape[1:3])
    featt = net(lambda: l2_normalize(feature_extractor(align["netFeatCoarse"], tgt)))
    feats = net(lambda: l2_normalize(feature_extractor(align["netFeatCoarse"], src_warp)))
    with torch.no_grad():
        corr12, corr21 = correlation_pair(featt, feats, 7)
    logits = [net(lambda n=n, c=c: head_logits(align[n], c))
              for n, c in (("netFlowCoarse", corr12), ("netMatch", corr12),
                           ("netMatch", corr21))]
    with torch.no_grad():
        flow_down8, m12, m21, match_down8 = head_epilogues(*logits, 7)
        flow, match = compose_tail(flow_down8, m12, m21, grid, False)
    return {"featt": featt, "feats": feats, "flow": flow, "match": match,
            "flow_down8": flow_down8, "match_down8": match_down8}


def _fine_fold_gaps(gen):
    """A whole fine pass, frozen against unfolded, on the alignment
    networks of `ACCEPT_WEIGHTS` (as the benchmark's alignment cells load
    them) at 480x640, one pair and two: each output's max abs gap (keys
    `fine_gap_*`), and kernel 15's launches a frozen pass (42: 15 for each
    of the two extractor passes, 4 for each of the three head trunks)."""
    from ransacflow_tpu_torch import kernels
    from ransacflow_tpu_torch.models.convert import alignment_params_from_tree, load_params_npz

    align = alignment_params_from_tree(load_params_npz(ACCEPT_WEIGHTS), "cuda")
    out = {}
    ht, wt = TARGET_HW
    for b in (1, 2):
        src = torch.rand((b, ht, wt, 3), generator=gen, device="cuda")
        tgt = torch.rand((b, ht, wt, 3), generator=gen, device="cuda")
        h21 = torch.eye(3, device="cuda").repeat(b, 1, 1)
        h21[:, 0, 2] = 0.05
        want = _fine_pass(align, src, tgt, h21, frozen=False)
        kernels.reset_launch_counts()
        got = _fine_pass(align, src, tgt, h21, frozen=True)
        torch.cuda.synchronize()
        n = kernels.launch_counts()["fine_conv"]
        require(n == 42, f"frozen fine pass: {n} fine_conv launches, expected 42")
        for key in want:
            gap = (got[key] - want[key]).abs().max().item()
            out[f"fine_gap_{key}"] = max(out.get(f"fine_gap_{key}", 0.0), gap)
    require(out["fine_gap_flow"] <= 5e-6 and out["fine_gap_match_down8"] <= 1.5e-6,
            f"frozen fine pass: {out}")
    return out


def check_fine_conv(gen):
    """K15 at every fine-stage call of the alignment cells (`K15_CALLS`) at
    batch 32 and 1 (keys `_<name>_b<batch>`) against its plain version
    (cuDNN, TF32 off), max abs error over the largest output; bound: the
    operations (2 M N K) or the bytes (input, weight, output, shortcut once)
    at the card's peaks; `library_ms`: cuDNN's pick for the convolution
    alone in the layout the unfolded network hands it (channels-last at the
    stem and the heads, NCHW in the blocks), which the port never calls.
    The unsuffixed keys repeat layer2's 3x3 at batch 32. Then a whole fine
    pass, frozen against unfolded (`_fine_fold_gaps`)."""
    import torch.nn.functional as F

    from ransacflow_tpu_torch.kernels.fine_conv import fine_conv, fine_conv_ref, pack_conv

    out = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    for b in K15_BATCHES:
        for name, cin, cout, k, stride, h, w, epi in K15_CALLS:
            suffix = f"_{name}_b{b}"
            pad = k // 2
            ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
            x = torch.rand((b, h, w, cin), generator=gen, device="cuda")
            wt = torch.randn((cout, cin, k, k), generator=gen, device="cuda") * (2 / (k * k * cin)) ** 0.5
            bias = None if epi == "none" else 0.1 * torch.randn((cout,), generator=gen, device="cuda")
            res = (torch.randn((b, ho, wo, cout), generator=gen, device="cuda")
                   if epi == "shortcut" else None)
            pc = pack_conv(wt, bias, stride, pad)
            with torch.inference_mode():
                got = fine_conv(x, pc, res)
                want = fine_conv_ref(x, pc, res)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            rel = err / max(want.abs().max().item(), 1e-30)
            out["max_abs_err"] = max(out["max_abs_err"], err)
            out["max_rel_err"] = max(out["max_rel_err"], rel)
            out["rel_err" + suffix] = rel
            require(rel <= K15_RTOL, f"fine_conv{suffix}: error {rel} of the largest output")
            xl = x.permute(0, 3, 1, 2)
            if name.startswith("layer"):
                xl = xl.contiguous()
            with torch.inference_mode():
                out.update(paired_ms(lambda: fine_conv(x, pc, res),
                                     lambda: fine_conv_ref(x, pc, res), suffix=suffix))
                out.update(library(lambda: F.conv2d(xl, wt, None, stride, pad), suffix))
            out.update(bound(nbytes(x, wt, got) + (nbytes(res) if res is not None else 0),
                             2 * b * ho * wo * cout * k * k * cin, suffix))
            print(f"(c) fine_conv{suffix}: rel_err={rel:.3g} "
                  f"ms={out['ms' + suffix]:.4f} device_ms={out['device_ms' + suffix]} "
                  f"library_device_ms={out['library_device_ms' + suffix]} "
                  f"bound_ms={out['bound_ms' + suffix]:.4f}", flush=True)
            del x, got, want, res
    # the kernel table's unsuffixed keys: layer2's 3x3 at batch 32, the call
    # that cuDNN took to FFT
    out.update({key: out[key + "_layer2_b32"] for key in (
        "ms", "plain_ms", "device_ms", "plain_device_ms", "library_ms", "library_device_ms",
        "bound_ms", "bound_by", "bound_bytes", "bound_ops")})
    out.update(_fine_fold_gaps(gen))
    return out


def phase_kernels():
    """Each kernel's check, its line printed as soon as it passes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = ((("lanczos_pyramid",), check_pyramid),
              (("correlation_volume", "correlation_pair"), check_correlation),
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
              (("ppm_pool",), check_ppm_pool),
              (("conv_epilogue",), check_conv_epilogue),
              (("fine_conv",), check_fine_conv))
    results = {}

    def shares(r):
        for key in [k for k in r if k.startswith("bound_ms")]:
            suffix = key[len("bound_ms"):]  # share: bound over device time
            dev = r.get("device_ms" + suffix)
            r["share" + suffix] = r[key] / dev if dev else None

    for names, check in checks:
        got = check(gen)
        for name, r in zip(names, got if len(names) > 1 else (got,)):
            shares(r)
            results[name] = r
            print(f"(c) {name}: " + ", ".join(f"{k}={v}" for k, v in r.items()), flush=True)
    for name, check in BATCH_CHECKS:  # the batch forms, under their own suffixes
        got = check(gen)
        shares(got)
        results[name].update(got)
        print(f"(c) {name}, batch form: " + ", ".join(f"{k}={v}" for k, v in got.items()),
              flush=True)
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
    from ransacflow_tpu_torch.pipeline.fused import (
        _coarse_match_batch, device_pyramid, fused_align)

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
            matches[device] = [m[0].cpu() for m in _coarse_match_batch(resnet, pyr, target,
                                                                       **mode)]
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


def _per_fine_pass(launches, grid_form=0):
    """The counts a fine pass fixes on an alignment path: per fine pass (one
    per compose_tail launch) one warp_homography, one correlation_pair (both
    volumes) and one head_epilogues (its three epilogues), no single
    correlation_volume, and `grid_form` warp_sample."""
    return {"warp_homography": launches["compose_tail"], "warp_sample": grid_form,
            "correlation_pair": launches["compose_tail"], "correlation_volume": 0,
            "head_epilogues": launches["compose_tail"]}


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
    _require_launched("serving path", launches, SERVING_KERNELS + ("conv_epilogue",),
                      {"lanczos_pyramid": 1, "ransac_adaptive": 0, "anchor_resample": 0,
                       "compose_tail": N_PAIRS, "fine_conv": 42 * N_PAIRS,
                       **_per_fine_pass(launches)})
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
    from ransacflow_tpu_torch.kernels.correlation import correlation_pair
    from ransacflow_tpu_torch.kernels.warp_sample import warp_homography, warp_sample
    from ransacflow_tpu_torch.models.feature_extractor import feature_extractor
    from ransacflow_tpu_torch.kernels.heads import head_epilogues
    from ransacflow_tpu_torch.models.heads import head_logits
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
        corr12, corr21 = stage("correlation", lambda: correlation_pair(featt_fine, feats, 7))
        flow8, m12, m21, _ = stage("heads", lambda: head_epilogues(
            head_logits(align["netFlowCoarse"], corr12),
            head_logits(align["netMatch"], corr12),
            head_logits(align["netMatch"], corr21), 7))
        stage("compose", lambda: compose_tail(flow8, m12, m21, grid, False))
        torch.cuda.synchronize()
        samples.append({name: a.elapsed_time(b) for name, (a, b) in marks.items()})
    return {name: float(np.median([smp[name] for smp in samples[1:]])) for name in samples[0]}


def _loop_batch(resnet, align, sources, targets, shapes, adaptive_chunk):
    """`_fused_multi_homo_batch` at bench.py's HPatches configuration over
    the pairs (sources, targets): each pair's bank from the device pyramid,
    its cached matches and fine features, pair k drawing from seed
    MH_SEED + k."""
    from ransacflow_tpu_torch.ops.grid import feature_cell_coords
    from ransacflow_tpu_torch.ops.matching import mutual_matching
    from ransacflow_tpu_torch.pipeline.bank import bank_coords
    from ransacflow_tpu_torch.pipeline.coarse import _coarse_feats
    from ransacflow_tpu_torch.pipeline.fine import fine_features
    from ransacflow_tpu_torch.pipeline.fused import device_pyramid
    from ransacflow_tpu_torch.pipeline.multihomo import _fused_multi_homo_batch

    ht, wt = TARGET_HW
    fh, fw = ht // 16, wt // 16
    y, x = feature_cell_coords(fh, fw, "cuda")
    coords_a, coords_b = bank_coords(shapes, "cuda"), torch.stack([x, y], dim=1)

    def setup(source, target):
        pyr = device_pyramid(source, shapes)
        bank = torch.cat([_coarse_feats(resnet, im) for im in pyr])
        featt = _coarse_feats(resnet, target)
        m = mutual_matching(bank.T, featt.T)
        return (bank, featt, m.src_idx, m.valid, pyr[len(shapes) // 2],
                fine_features(align, target))

    with torch.inference_mode():
        banks, featts, src_idx, valids, mids, ffines = (
            torch.stack(z) for z in zip(*map(setup, sources, targets)))
        gens = [torch.Generator(device="cuda").manual_seed(MH_SEED + k)
                for k in range(len(sources))]
        return _fused_multi_homo_batch(
            align, banks, featts, coords_a, coords_b, src_idx, valids, mids, ffines,
            torch.ones((len(sources), ht, wt), device="cuda"), gens, 0.05, 0.01, feat_h=fh,
            feat_w=fw, max_coarse=MH_MAX_COARSE, cycle_match=False, kernel_size=7,
            n_iter=MH_N_ITER, rematch=False, adaptive_chunk=adaptive_chunk)


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
    from ransacflow_tpu_torch.utils.image import pyramid_shapes

    t0 = time.perf_counter()
    shapes = pyramid_shapes()
    ht, wt = TARGET_HW
    srcs_np, tgts_np = _related_pairs(np.random.RandomState(1), N_PAIRS, shapes[0])
    sources = torch.from_numpy(srcs_np).cuda()[:, None]
    targets = torch.from_numpy(tgts_np).cuda()[:, None]
    resnet = init_resnet50_layer3(torch.Generator().manual_seed(0), "cuda")
    align = alignment_params_from_tree(load_params_npz(ACCEPT_WEIGHTS), "cuda")
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

    def run(adaptive_chunk):
        return _loop_batch(resnet, align, sources, targets, shapes, adaptive_chunk)

    series = {"adaptive": MH_CHUNK, "fixed": 0}
    outs, launches = {}, {}
    for name, chunk in series.items():
        outs[name], launches[f"multihomo_{name}"] = _launches_of(lambda: run(chunk))
    no_k3 = tuple(k for k in MULTIHOMO_KERNELS if k != "ransac_score")
    _require_launched("multi-homography loop, adaptive", launches["multihomo_adaptive"],
                      no_k3, {"ransac_score": 0,
                              **_per_fine_pass(launches["multihomo_adaptive"])})
    _require_launched("multi-homography loop, fixed", launches["multihomo_fixed"],
                      SERVING_KERNELS, {"ransac_adaptive": 0,
                                        **_per_fine_pass(launches["multihomo_fixed"])})
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
               "correlation_pair", "head_epilogues", "compose_tail", "blur_pool")


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


def _rematch_trace(coarse):
    """One rematching call (`pipeline.coarse._match_masked` with a partial
    mask, as every slot of a rematching loop makes it) under the profiler:
    its device kernels are the score GEMM and K2's two, and no elementwise
    pass multiplies the score by the mask. Returns their names."""
    from torch.profiler import ProfilerActivity, profile

    from ransacflow_tpu_torch.pipeline.coarse import _match_masked

    keep = torch.rand(coarse._featt.shape[0], generator=torch.Generator(device="cuda")
                      .manual_seed(3), device="cuda") > 0.3

    def rematch():
        return _match_masked(coarse._bank, coarse._featt, keep, None, None, True,
                             coarse.relax_cells, coarse.feat_w)

    _, launches = _launches_of(rematch)
    _require_launched("rematch", launches, exact={"mutual_argmax": 1})
    # a session may miss its first launches (the score GEMM, or all of them):
    # a spin kernel goes first, then three calls, and a session that did not
    # record all three kernels of a call is taken again
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(100000)
            for _ in range(3):
                rematch()
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages()
                        if e.self_device_time_total > 0 and "spin_kernel" not in e.key})
        if all(any(k in n for n in names) for k in ("gemm", "chunk_kernel", "merge_kernel")):
            break
    print(f"(g) one rematching call, device kernels: {names}", flush=True)
    require(all(any(k in n for n in names) for k in ("gemm", "chunk_kernel", "merge_kernel")),
            f"rematch: the GEMM and K2's two kernels not all in the trace: {names}")
    require(len(names) == 3, f"rematch: kernels besides the GEMM and K2's two: {names}")
    require(not any("elementwise" in n.lower() or "MulFunctor" in n for n in names),
            f"rematch: an elementwise pass over the score: {names}")
    return names


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

    # each pair's bank is one K12 launch (every scale, the anchors' own included)
    per_batch = {"anchor_resample": N_PAIRS, "lanczos_pyramid": 1, "compose_tail": N_PAIRS}
    launches, outs = {}, {}
    outs["anchor3_relax1"], launches["fast_serving_fixed"] = _launches_of(
        lambda: serve(series["anchor3_relax1"]))
    _require_launched("fast serving, fixed", launches["fast_serving_fixed"],
                      SERVING_KERNELS, dict(per_batch, ransac_adaptive=0))
    _require_launched("fast serving, fixed", launches["fast_serving_fixed"],
                      exact=_per_fine_pass(launches["fast_serving_fixed"]))
    outs["anchor3_relax1_adaptive4096"], launches["fast_serving_adaptive"] = _launches_of(
        lambda: serve(series["anchor3_relax1_adaptive4096"]))
    _require_launched("fast serving, adaptive", launches["fast_serving_adaptive"],
                      [k for k in FAST_KERNELS if k != "ransac_score"],
                      dict(per_batch, ransac_score=0,
                           **_per_fine_pass(launches["fast_serving_adaptive"])))

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
                       "correlation_pair", "head_epilogues", "compose_tail", "blur_pool"),
                      {"anchor_resample": 1, "ransac_score": 0, "lanczos_pyramid": 0,
                       # warped_fine is the one grid-form warp
                       **_per_fine_pass(launches["align_images"], grid_form=1)})
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
    loop_kernels = ("mutual_argmax", "ransac_score", "warp_homography", "correlation_pair",
                    "head_epilogues", "compose_tail", "blur_pool")
    _, launches["loop_set_pair_anchor"] = _launches_of(
        lambda: coarse.set_pair(_to_pil(srcs_np[0]), _to_pil(tgts_np[0])))
    _require_launched("set_pair, anchor mode", launches["loop_set_pair_anchor"],
                      exact={"anchor_resample": 1, "mutual_argmax": 0})  # rematch: none cached
    host, launches["loop_relax1_host"] = _launches_of(
        lambda: multi_homography_predict(coarse, align_mh, **kw))
    _require_launched("host loop, relax 1", launches["loop_relax1_host"], loop_kernels,
                      {"anchor_resample": 0, "ransac_adaptive": 0,
                       **_per_fine_pass(launches["loop_relax1_host"])})
    fused, launches["loop_relax1_device"] = _launches_of(
        lambda: multi_homography_predict_fused(
            coarse, align_mh, generator=torch.Generator(device="cuda").manual_seed(MH_SEED),
            **kw))
    _require_launched("device loop, relax 1", launches["loop_relax1_device"], loop_kernels,
                      {"anchor_resample": 0, "ransac_adaptive": 0,
                       **_per_fine_pass(launches["loop_relax1_device"])})
    require(host is not None and fused is not None, "relaxed loops found nothing")
    readings["rematch_kernels"] = _rematch_trace(coarse)
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
                      {"ppm_pool": len(SkySegmenter.IMG_SIZES) * N_PAIRS, **_per_fine_pass(hook)})
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
                "warp_sample_kernel", "correlation_", "epilogue")
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
    require(launches["head_epilogues"] == 2 and launches["head_epilogues_bwd"] == 2,
            f"training path: K7 launched {launches['head_epilogues']} forward and "
            f"{launches['head_epilogues_bwd']} backward, expected 2 and 2")
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


EVAL_PAIRS = 2
# a harness's fine passes: K2 (cached matching), K3, K5h, K6's pair, K7, K8, K9
EVAL_KERNELS = ("mutual_argmax", "ransac_score", "warp_homography", "correlation_pair",
                "head_epilogues", "compose_tail", "blur_pool")
KITTI_HW, KITTI_SHIFT = (375, 1242), 15  # KITTI's size; the target is the source 15 rows up
# (dx, dy) px of each HPatches and corr pair: target(x, y) = source(x - dx, y - dy)
EVAL_SHIFTS = ((16, 16), (32, 16))


def _png16(path, img):
    """uint16 (H, W, 3) in cv2's B, G, R order as a 16-bit RGB PNG, rows
    unfiltered: KITTI's ground truth, written without cv2."""
    import struct
    import zlib

    h = img.shape[0]
    rows = np.ascontiguousarray(img[..., ::-1]).astype(">u2").view(np.uint8).reshape(h, -1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1], h, 16, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(b"\0" + r.tobytes() for r in rows)))
                + chunk(b"IEND", b""))


def _write_csv(path, rows):
    import csv

    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


def _eval_datasets(root):
    """Phase (i)'s synthetic sets under `root`, images made with numpy from a
    seed and saved with PIL. HPatches: 2 pairs of 640x480, each target its
    source translated by EVAL_SHIFTS (planted homographies in the CSV).
    KITTI: 2 pairs of 1242x375, each target its source 15 rows up (an exact
    2-cell shift at coarseSize 800), ground truth u = 0, v = 15 where the
    source holds the pixel. Corr: 2 translated pairs of 640x480 with 40
    annotated points each."""
    rng = np.random.RandomState(11)
    hp_rows, corr_rows = [], []
    for d in ("hpatches", "corr", "kitti/image_2", "kitti/flow_noc"):
        os.makedirs(f"{root}/{d}")
    for k, (dx, dy) in enumerate(EVAL_SHIFTS):
        shift = lambda a: np.roll(a, (dy, dx), axis=(0, 1))  # noqa: E731
        base = _blocky(rng, 1, *TARGET_HW)[0]
        os.makedirs(f"{root}/hpatches/obj{k}")
        _to_pil(base).save(f"{root}/hpatches/obj{k}/1.ppm")
        _to_pil(shift(base)).save(f"{root}/hpatches/obj{k}/2.ppm")
        h_px = np.array([[1, 0, dx], [0, 1, dy], [0, 0, 1]], np.float64)  # source px -> target px
        hp_rows.append({"obj": f"obj{k}", "im1": 1, "im2": 2, "Him": TARGET_HW[0],
                        "Wim": TARGET_HW[1], **{f"h{r}{c}": h_px[r, c] for r in range(3)
                                                for c in range(3)}})
        base = _blocky(rng, 1, *TARGET_HW)[0]
        _to_pil(base).save(f"{root}/corr/a{k}.png")
        _to_pil(shift(base)).save(f"{root}/corr/b{k}.png")
        xt = rng.randint(TARGET_HW[1] // 8, TARGET_HW[1] * 7 // 8, 40)
        yt = rng.randint(TARGET_HW[0] // 8, TARGET_HW[0] * 7 // 8, 40)
        corr_rows.append({"scene": "/", "source_image": f"a{k}.png", "target_image": f"b{k}.png",
                          "XA": ";".join(map(str, xt - dx)), "YA": ";".join(map(str, yt - dy)),
                          "XB": ";".join(map(str, xt)), "YB": ";".join(map(str, yt))})
        h, w = KITTI_HW
        img = _blocky(rng, 1, h + KITTI_SHIFT + 2, w + 2)[0]  # sides multiples of 4
        _to_pil(img[:h, :w]).save(f"{root}/kitti/image_2/{k:06}_11.png")
        _to_pil(img[KITTI_SHIFT:h + KITTI_SHIFT, :w]).save(f"{root}/kitti/image_2/{k:06}_10.png")
        gt = np.zeros((h, w, 3), np.uint16)  # (valid, v, u), each stored + 2^15 after * 64
        gt[: h - KITTI_SHIFT, :, 0] = 1
        gt[..., 1] = 32768 + 64 * KITTI_SHIFT
        gt[..., 2] = 32768
        _png16(f"{root}/kitti/flow_noc/{k:06}_10.png", gt)
    _write_csv(f"{root}/hpatches/hpatches_1_2.csv", hp_rows)
    _write_csv(f"{root}/corr/pairs.csv", corr_rows)


def _check_artifacts(name, out_dir, n_max=None, extra=()):
    """Every pair has an artifact of the JAX package's fields (and `extra`),
    finite, with 1 to n_max homographies. Returns the homographies a pair."""
    from ransacflow_tpu_torch.eval.artifacts import FIELDS, check_complete, load_pair

    missing = check_complete(out_dir, range(EVAL_PAIRS))
    require(not missing, f"{name}: no artifact for pairs {missing}")
    counts = []
    for i in range(EVAL_PAIRS):
        art = load_pair(out_dir, i)
        require(set(art) == set(FIELDS) | set(extra), f"{name}: pair {i}: fields {sorted(art)}")
        n = art["coarse_h"].shape[0]
        require(1 <= n and (n_max is None or n <= n_max), f"{name}: pair {i}: {n} homographies")
        for key, a in art.items():
            require(key == "bg_mask" or a.ndim == 0 or a.shape[0] == n,
                    f"{name}: pair {i}: {key} {a.shape}")
            require(bool(np.isfinite(a).all()), f"{name}: pair {i}: {key} is not finite")
        counts.append(n)
    return counts


def _timed(fn):
    """(fn(), seconds) on the host clock; fn ends in host reads."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _kitti_card_vs_cpu(pred_dir, gt_dir, th=1.0, cc_th=0.01):
    """KITTI's results pass (its defaults) on the card against the CPU, pair
    by pair. The composed stacks, K8 against its plain version at the
    ground truth's size, agree within 1e-5 off the in-bounds step. The EPE
    agrees within 1e-3 px off the pixels whose merge or cc decision flips:
    a matchability within 1e-6 of th (1.0, which the sigmoids reach in
    fp32) or of the cc threshold 0.99, read on either side of it on the two
    devices. Returns (largest EPE gap, largest gap off the flips, flipped
    pixels a pair)."""
    from ransacflow_tpu_torch.eval import kitti
    from ransacflow_tpu_torch.eval.artifacts import load_pair
    from ransacflow_tpu_torch.eval.compose import match_channels, put
    from ransacflow_tpu_torch.kernels.compose import compose_tail
    from ransacflow_tpu_torch.ops.homography import warp_grid

    gap, gap_off, flipped = 0.0, 0.0, []
    for i in range(EVAL_PAIRS):
        art = load_pair(pred_dir, i)
        u, v, valid = kitti.read_kitti_flow(f"{gt_dir}/{i:06}_10.png")
        ht, wt = u.shape
        maps, errs = {}, {}
        for dev in ("cuda", "cpu"):
            with torch.inference_mode():
                flow_d2 = kitti._compose(put(art["fine_flow_d2_down8"], dev),
                                         warp_grid(put(art["coarse_h"], dev), ht, wt))
                flow, match = compose_tail(put(art["fine_flow_down8"], dev),
                                           *match_channels(put(art["fine_match_down8"], dev)),
                                           flow_d2, True)
            maps[dev] = flow.cpu().numpy(), match.cpu().numpy()
            grid = np.stack(np.meshgrid(np.linspace(-1, 1, wt), np.linspace(-1, 1, ht)), -1)
            est = kitti.compose_kitti_flow(art, ht, wt, dev, th=th, cc_th=cc_th)
            du = (est[..., 0] - grid[..., 0]) * (wt - 1) / 2
            dv = (est[..., 1] - grid[..., 1]) * (ht - 1) / 2
            errs[dev] = np.sqrt((du - u) ** 2 + (dv - v) ** 2)
        (fc, mc), (fp, mp) = maps["cuda"], maps["cpu"]
        off = (np.abs(np.abs(fp) - 1) > 1e-5).all(-1)
        err = max(np.abs(fc - fp).max(), np.abs(mc - mp)[off].max())
        require(err <= 1e-5, f"KITTI results pass, pair {i}: K8 on the card {err} from the CPU")
        flips = np.zeros((ht, wt), bool)
        for t in (th, 0.99):
            side = (mc >= t) != (mp >= t)
            require(bool((np.abs(mc - mp)[side] <= 1e-6).all()),
                    f"KITTI results pass, pair {i}: a flip at {t} more than 1e-6 apart")
            flips |= side.any(0)
        keep = valid & ~flips
        gap = max(gap, abs(float((errs["cuda"] * valid).sum() / valid.sum())
                           - float((errs["cpu"] * valid).sum() / valid.sum())))
        gap_off = max(gap_off, abs(float(errs["cuda"][keep].mean() - errs["cpu"][keep].mean())))
        flipped.append(int(flips.sum()))
    require(gap_off <= 1e-3, f"KITTI: the card's EPE is {gap_off} px from the CPU's off the "
                             f"{flipped} pixels whose decisions flip")
    return gap, gap_off, flipped


def check_compose_kitti(art):
    """K8 on KITTI's real shapes and data, from a pair's artifact: the
    inter-pass compose (the d2 pass's stride-8 flow into the fineSize
    homography grid, suffix `_kitti_grid`) and pass 2 (its stride-8 flow
    and matchability, that grid composed at 375x1242 with cycle_match,
    suffix `_kitti`), against the plain version."""
    from ransacflow_tpu_torch.eval.compose import match_channels, put
    from ransacflow_tpu_torch.kernels.compose import compose_tail, compose_tail_ref
    from ransacflow_tpu_torch.ops.homography import warp_grid

    h8, w8 = art["fine_flow_down8"].shape[1:3]
    d2 = put(art["fine_flow_d2_down8"][:1], "cuda")
    unused = torch.zeros(d2.shape[:3] + (1,), device="cuda")
    grid_args = (d2, unused, unused, warp_grid(put(art["coarse_h"][:1], "cuda"), 8 * h8, 8 * w8),
                 False, None)
    pass2_args = (put(art["fine_flow_down8"][:1], "cuda"),
                  *match_channels(put(art["fine_match_down8"][:1], "cuda")),
                  compose_tail_ref(*grid_args)[0].contiguous(), True, KITTI_HW)
    out = {}
    for suffix, args in (("_kitti_grid", grid_args), ("_kitti", pass2_args)):
        (flow, match), (flow_r, match_r) = compose_tail(*args), compose_tail_ref(*args)
        torch.cuda.synchronize()
        off = ((flow_r.abs() - 1).abs() > 1e-5).all(dim=-1)
        err = max((flow - flow_r).abs().max().item(), (match - match_r)[off].abs().max().item())
        require(err <= 1e-5, f"compose_tail{suffix}: max abs err {err}")
        out["max_abs_err" + suffix] = err
        out["shapes" + suffix] = [list(a.shape) for a in args[:4]] + [list(match.shape)]
        out.update(paired_ms(lambda: compose_tail(*args), lambda: compose_tail_ref(*args),
                             suffix=suffix))
        out.update(bound(nbytes(*args[:4], flow, match), 60 * match.numel(), suffix))
        out["share" + suffix] = out["bound_ms" + suffix] / out["device_ms" + suffix] \
            if out["device_ms" + suffix] else None
    return out


def _add_counts(*counts):
    return {name: sum(c[name] for c in counts) for name in counts[0]}


def phase_eval(card, kernel_results):
    """(i) The eval harnesses: predict and results passes of HPatches, KITTI
    and corr at their defaults on the card (`_eval_datasets`), seeded trunk,
    alignment nets from accept_weights.npz; each results pass held to the
    same pass on the CPU; K8 on KITTI's real pass-2 shapes."""
    import tempfile

    from ransacflow_tpu_torch.eval import corr, hpatches, kitti
    from ransacflow_tpu_torch.eval.artifacts import load_pair
    from ransacflow_tpu_torch.models.convert import (
        alignment_params_from_tree, init_resnet50_layer3, load_params_npz)

    t0 = time.perf_counter()
    resnet = init_resnet50_layer3(torch.Generator().manual_seed(0), "cuda")
    align = alignment_params_from_tree(load_params_npz(ACCEPT_WEIGHTS), "cuda")
    no_other = {"warp_sample": 0, "correlation_volume": 0, "ransac_adaptive": 0,
                "lanczos_pyramid": 0, "anchor_resample": 0}
    launches, readings = {}, {}
    with tempfile.TemporaryDirectory() as root:
        _eval_datasets(root)

        # HPatches: host loop, 7 scales, 50k hypotheses, max_coarse 10, 240x240 metric
        hp, pred = f"{root}/hpatches", f"{root}/pred_hpatches"
        (_, predict), predict_s = _timed(lambda: _launches_of(
            lambda: hpatches.predict_hpatches(hp, hp, pred, resnet, align, "cuda", scenes=(2,))))
        counts = _check_artifacts("HPatches", f"{pred}/2", n_max=11)
        ((_, aepe), results), results_s = _timed(lambda: _launches_of(
            lambda: hpatches.evaluate_hpatches(pred, hp, hp, "cuda", scenes=(2,))))
        cpu = hpatches.evaluate_hpatches(pred, hp, hp, "cpu", scenes=(2,))[1][2]
        gap = float(np.max(np.abs(np.subtract(aepe[2], cpu))))
        require(gap <= 1e-3, f"HPatches: the card's AEPE is {gap} px from the CPU's")
        coarse = hpatches.evaluate_hpatches(pred, hp, hp, "cuda", scenes=(2,),
                                            only_coarse=True)[1][2]
        _require_launched("eval_hpatches predict", predict, EVAL_KERNELS,
                          {**no_other, **_per_fine_pass(predict)})
        _require_launched("eval_hpatches results", results,
                          exact={"compose_tail": EVAL_PAIRS, "warp_homography": 0})
        launches["eval_hpatches"] = _add_counts(predict, results)
        readings["hpatches"] = {
            "pairs_s": EVAL_PAIRS / predict_s, "results_ms_per_pair": results_s * 1e3 / EVAL_PAIRS,
            "aepe_px": aepe[2], "coarse_aepe_px": coarse, "card_vs_cpu_px": gap,
            "homographies": counts}
        print(f"(i) HPatches, {EVAL_PAIRS} pairs of 640x480 (7 scales, 50k, max_coarse 10): "
              f"predict {readings['hpatches']['pairs_s']:.3f} pairs/s ({predict_s:.2f} s), "
              f"results {readings['hpatches']['results_ms_per_pair']:.1f} ms a pair (host "
              f"clock); AEPE {aepe[2]} px, coarse-only {coarse} px against the planted "
              f"homographies; card vs CPU {gap:.2e} px; homographies {counts}; launches "
              f"predict {predict}, results {results} on {card}", flush=True)

        # KITTI: coarseSize 800, 3 scales, fineSize 650, cc_th 0.01, the two-resolution loop
        kt, kpred = f"{root}/kitti", f"{root}/pred_kitti"
        cc_seconds = []
        remove_small_cc = kitti.remove_small_cc

        def timed_cc(*args, **kwargs):
            t1 = time.perf_counter()
            out = remove_small_cc(*args, **kwargs)
            cc_seconds.append(time.perf_counter() - t1)
            return out

        kitti.remove_small_cc = timed_cc  # the host's cleanup, each iteration
        try:
            (_, predict), predict_s = _timed(lambda: _launches_of(
                lambda: kitti.predict_kitti(f"{kt}/image_2", kpred, resnet, align, "cuda",
                                            end_index=EVAL_PAIRS)))
        finally:
            kitti.remove_small_cc = remove_small_cc
        counts = _check_artifacts("KITTI", kpred, extra=("fine_flow_d2_down8",))
        iterations = predict["warp_homography"]
        ((_, epe), results), results_s = _timed(lambda: _launches_of(
            lambda: kitti.evaluate_kitti(kpred, f"{kt}/flow_noc", "cuda", n_pairs=EVAL_PAIRS)))
        gap, gap_off, flipped = _kitti_card_vs_cpu(kpred, f"{kt}/flow_noc")
        _, decode_s = _timed(lambda: [kitti.read_kitti_flow(f"{kt}/flow_noc/{i:06}_10.png")
                                      for i in range(EVAL_PAIRS)])  # the results pass's PNG reads
        coarse = kitti.evaluate_kitti(kpred, f"{kt}/flow_noc", "cuda", n_pairs=EVAL_PAIRS,
                                      only_coarse=True)[1]
        # an iteration: pass 1 (K5h, K6 pair, K7, K8), the inter-pass K8, pass 2 (K5's
        # grid form, K6 pair, K7, K8 across resolutions)
        _require_launched("eval_kitti predict", predict, EVAL_KERNELS + ("warp_sample",), {
            **no_other, "warp_sample": iterations, "compose_tail": 3 * iterations,
            "correlation_pair": 2 * iterations, "head_epilogues": 2 * iterations})
        _require_launched("eval_kitti results", results,
                          exact={"compose_tail": 2 * EVAL_PAIRS, "warp_homography": 0})
        launches["eval_kitti"] = _add_counts(predict, results)
        k8 = check_compose_kitti(load_pair(kpred, 0))
        row = kernel_results["compose_tail"]
        row.update(k8)
        row["max_abs_err"] = max(row["max_abs_err"], k8["max_abs_err_kitti"],
                                 k8["max_abs_err_kitti_grid"])
        readings["kitti"] = {
            "pairs_s": EVAL_PAIRS / predict_s, "results_ms_per_pair": results_s * 1e3 / EVAL_PAIRS,
            "epe_px": epe, "coarse_epe_px": coarse, "card_vs_cpu_px": gap,
            "card_vs_cpu_px_off_flips": gap_off, "flipped_px": flipped,
            "homographies": counts, "iterations": iterations,
            "cc_host_s": sum(cc_seconds), "cc_host_share": sum(cc_seconds) / predict_s,
            "gt_decode_ms_per_pair": decode_s * 1e3 / EVAL_PAIRS,
            "compose_tail_per_iteration": predict["compose_tail"] / iterations}
        print(f"(i) KITTI, {EVAL_PAIRS} pairs of 1242x375 (coarseSize 800, 3 scales, 50k, "
              f"fineSize 650): predict {readings['kitti']['pairs_s']:.3f} pairs/s "
              f"({predict_s:.2f} s, {iterations} iterations; the host's cc cleanup "
              f"{sum(cc_seconds):.3f} s = {readings['kitti']['cc_host_share']:.3f} of it), "
              f"results {readings['kitti']['results_ms_per_pair']:.1f} ms a pair (its ground "
              f"truth's PNG decode {readings['kitti']['gt_decode_ms_per_pair']:.1f}); EPE {epe} px, "
              f"coarse-only {coarse} px against the planted flow; card vs CPU {gap:.2e} px, "
              f"{gap_off:.2e} off the {flipped} pixels whose th = 1.0 or cc decision flips; "
              f"homographies {counts}; K8 on pass 2's shapes {k8['shapes_kitti']}: err "
              f"{k8['max_abs_err_kitti']:.2e}, device {k8['device_ms_kitti']} ms (plain "
              f"{k8['plain_device_ms_kitti']}), bound {k8['bound_ms_kitti']:.4f}; the "
              f"inter-pass grid {k8['shapes_kitti_grid']}: err {k8['max_abs_err_kitti_grid']:.2e}"
              f", device {k8['device_ms_kitti_grid']} ms; launches predict {predict}, results "
              f"{results} on {card}", flush=True)

        # corr: host loop, 7 scales, 10k hypotheses, cycle match, MegaDepth precision
        cp, cpred = f"{root}/corr", f"{root}/pred_corr"
        (_, predict), predict_s = _timed(lambda: _launches_of(
            lambda: corr.predict_corr(f"{cp}/pairs.csv", cp, cpred, resnet, align, "cuda")))
        counts = _check_artifacts("corr", cpred, n_max=11)
        (prec, results), results_s = _timed(lambda: _launches_of(
            lambda: corr.evaluate_corr(cpred, f"{cp}/pairs.csv", cp, "cuda")))
        prec_cpu = corr.evaluate_corr(cpred, f"{cp}/pairs.csv", cp, "cpu")
        require(prec[0.0][1] == prec_cpu[0.0][1] and np.array_equal(prec[0.0][0], prec_cpu[0.0][0]),
                f"corr: the card's precision {prec} differs from the CPU's {prec_cpu}")
        _require_launched("eval_corr predict", predict, EVAL_KERNELS,
                          {**no_other, **_per_fine_pass(predict)})
        _require_launched("eval_corr results", results,
                          exact={"compose_tail": EVAL_PAIRS, "warp_homography": 0})
        launches["eval_corr"] = _add_counts(predict, results)
        readings["corr"] = {
            "pairs_s": EVAL_PAIRS / predict_s, "results_ms_per_pair": results_s * 1e3 / EVAL_PAIRS,
            "precision": prec[0.0][0].tolist(), "n_points": prec[0.0][1],
            "homographies": counts}
        print(f"(i) corr, {EVAL_PAIRS} pairs of 640x480 (7 scales, 10k, cycle match): predict "
              f"{readings['corr']['pairs_s']:.3f} pairs/s ({predict_s:.2f} s), results "
              f"{readings['corr']['results_ms_per_pair']:.1f} ms a pair; precision at "
              f"1-36 px {prec[0.0][0].tolist()} over {prec[0.0][1]} points, equal on the CPU; "
              f"homographies {counts}; launches predict {predict}, results {results} on "
              f"{card}; phase (i) {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, readings


YFCC_FOCAL, YFCC_DEPTH = 500.0, 5.0  # px; the textured plane's depth
YFCC_TH, YFCC_THRESHOLD = 0.95, 0.0005  # the results pass's --th and --threshold
# the camera of an image stored turned by 90 degrees counter-clockwise (PIL):
# its centred pixel (u, v) of the upright image is (v, -u)
TURN_90 = np.array([[0.0, 1, 0], [-1, 0, 0], [0, 0, 1]])
# generate_pairs: the planted shift (K2, K3, K5h) and a row it rejects (K2, K3)
GENERATE_KERNELS = ("mutual_argmax", "ransac_score", "warp_homography")


def _yfcc_dataset(root):
    """Phase (j)'s YFCC scene under `root`: 2 pairs of 640x480, each target
    its source translated by EVAL_SHIFTS, a textured plane at depth 5 seen
    by two cameras of focal 500 px whose second moves parallel to the plane
    (tests/test_eval.py:439); pair 1's target is stored turned by 90 degrees,
    its camera turned with it, so the pre-test must turn it back (270).
    Returns (pairs pkl, scene dir, the calibration records that
    `eval.yfcc.load_scene_calibration` reads from .h5 files)."""
    import pickle

    from ransacflow_tpu_torch.utils.image import min_size_shape_wh

    rng = np.random.RandomState(13)
    scene = f"{root}/yfcc/reichstag/test"
    os.makedirs(scene)
    os.makedirs(f"{root}/yfcc/pairs")
    K = np.diag([YFCC_FOCAL, YFCC_FOCAL, 1.0])
    names, calib = [], []
    for k, (dx, dy) in enumerate(EVAL_SHIFTS):
        base = _blocky(rng, 1, *TARGET_HW)[0]
        t = np.array([dx, dy, 0.0]) * YFCC_DEPTH / YFCC_FOCAL
        turn = TURN_90 if k == 1 else np.eye(3)
        for j, (img, R, tt) in enumerate(((base, np.eye(3), np.zeros(3)),
                                          (np.roll(base, (dy, dx), axis=(0, 1)), turn,
                                           turn @ t))):
            pil = _to_pil(img)
            if k == 1 and j == 1:
                pil = pil.rotate(90, expand=True)
            names.append(f"im{2 * k + j}.png")
            pil.save(f"{scene}/{names[-1]}")
            calib.append({"R": R, "t": tt[:, None], "K": K, "org_size": list(pil.size),
                          "resized": min_size_shape_wh(pil.size, TARGET_HW[0])})
    with open(f"{scene}/images.txt", "w") as f:
        f.write("\n".join(names) + "\n")
    pkl = f"{root}/yfcc/pairs/reichstag-te-1000-pairs.pkl"
    with open(pkl, "wb") as f:
        pickle.dump([[0, 1], [2, 3]], f)
    return pkl, scene, calib


def _pose_probe():
    """Wrap `eval.yfcc.estimate_pose` and `eval.pose.five_point_batch`:
    each pose call's points, host seconds and minimal sets solved. Returns
    (calls list, undo)."""
    from ransacflow_tpu_torch.eval import pose, yfcc

    calls = []
    estimate, solve = yfcc.estimate_pose, pose.five_point_batch

    def timed_estimate(pts1, pts2, *args, **kwargs):
        calls.append({"n1": np.array(pts1), "n2": np.array(pts2), "sets": 0})
        t1 = time.perf_counter()
        out = estimate(pts1, pts2, *args, **kwargs)
        calls[-1]["s"] = time.perf_counter() - t1
        return out

    def counted_solve(x1, x2):
        calls[-1]["sets"] += len(x1)
        return solve(x1, x2)

    yfcc.estimate_pose, pose.five_point_batch = timed_estimate, counted_solve

    def undo():
        yfcc.estimate_pose, pose.five_point_batch = estimate, solve

    return calls, undo


def _yfcc_card_vs_cpu(pred_dir, pkl, scene, calib):
    """YFCC's results pass (--multiH --ransac, th 0.95, threshold 0.0005) on
    the card against the CPU on the same artifacts and seed. The composed
    stacks (K8 against its plain version) agree within 1e-5 off the
    in-bounds step; the matched pixels are the same but where a
    matchability within 1e-6 of th reads on either side of it on the two
    devices; the matched points agree within 1e-5 (w - 1) / 2 px; where the
    point sets are equal, the pose errors are equal when the points are bit
    for bit the same, else within 1 degree (the pose tolerance of
    tests/test_torch_pose.py: K8's last bits move a point, and RANSAC may
    then keep another model). Returns (card's errors,
    accs, launches, seconds, pose calls, the CPU's errors, flipped pixels a
    pair, largest error gap)."""
    from ransacflow_tpu_torch.eval import yfcc
    from ransacflow_tpu_torch.eval.artifacts import load_pair
    from ransacflow_tpu_torch.eval.compose import reconstruct_flows

    kw = dict(multi_h=True, th=YFCC_TH, use_ransac=True, threshold=YFCC_THRESHOLD,
              calibration=calib)
    runs = {}
    for dev in ("cuda", "cpu"):
        calls, undo = _pose_probe()
        try:
            ((errors, accs), launches), seconds = _timed(lambda: _launches_of(
                lambda: yfcc.evaluate_yfcc(pred_dir, pkl, scene, dev, **kw)))
        finally:
            undo()
        runs[dev] = errors, accs, launches, seconds, calls
    flipped = []
    for i, (ia, ib) in enumerate(((0, 1), (2, 3))):
        art = load_pair(pred_dir, i)
        h8, w8 = art["fine_flow_down8"].shape[1:3]
        stacks = [reconstruct_flows(art["coarse_h"], art["fine_flow_down8"],
                                    art["fine_match_down8"], 8 * h8, 8 * w8, dev)
                  for dev in ("cuda", "cpu")]
        (fc, mc), (fp, mp) = stacks
        off = (np.abs(np.abs(fp) - 1) > 1e-5).all(-1)
        err = max(np.abs(fc - fp).max(), np.abs(mc - mp)[off].max())
        require(err <= 1e-5, f"YFCC results pass, pair {i}: K8 on the card {err} from the CPU")
        side = (mc >= YFCC_TH) != (mp >= YFCC_TH)
        require(bool((np.abs(mc - mp)[side] <= 1e-6).all()),
                f"YFCC results pass, pair {i}: a flip at th more than 1e-6 apart")
        flips = side.any(0) & art["bg_mask"]
        flipped.append(int(flips.sum()))
        _, pts2 = yfcc.matches_from_flow(fp[0], flips, calib[ia]["resized"], calib[ib]["resized"],
                                         int(art["rotation"]))
        near = {tuple(k) for k in yfcc.norm_kp(calib[ib]["org_size"], calib[ib]["resized"],
                                               calib[ib]["K"], pts2.astype(np.float64))}
        got, want = runs["cuda"][4][i], runs["cpu"][4][i]
        a = {tuple(k): p for p, k in zip(got["n1"], got["n2"])}
        b = {tuple(k): p for p, k in zip(want["n1"], want["n2"])}
        require(set(a) ^ set(b) <= near, f"YFCC pair {i}: the matched pixels differ off the "
                                         f"{len(near)} pixels whose th decision flips")
        common = [k for k in a if k in b and k not in near]
        gap = max((np.abs(a[k] - b[k]).max() for k in common), default=0.0)
        tol = 1e-5 * (calib[ib]["resized"][0] - 1) / 2 / YFCC_FOCAL
        require(gap <= tol, f"YFCC pair {i}: matched points {gap} apart (normalized)")
        if set(a) == set(b):  # the same seed: equal errors on equal points, else 1 degree
            same = all(np.array_equal(a[k], b[k]) for k in a)
            e_card, e_cpu = runs["cuda"][0][i], runs["cpu"][0][i]
            require(e_card == e_cpu if same else abs(e_card - e_cpu) <= 1.0,
                    f"YFCC pair {i}: pose error {e_card} on the card, {e_cpu} on the CPU "
                    f"(points {'equal' if same else 'within 1e-5 px'}, one seed)")
    gap = float(np.max(np.abs(np.subtract(runs["cuda"][0], runs["cpu"][0]))))
    return (*runs["cuda"], runs["cpu"][0], runs["cpu"][3], flipped, gap)


def phase_yfcc(card):
    """(j) The YFCC harness at its defaults on the card (`_yfcc_dataset`),
    its predict pass in the host loop and the device loop (`--nDevices 1`),
    its results pass held to the CPU's; the Aachen export on one pair; and
    `cli.generate_pairs` on a kept and a rejected row. Seeded trunk,
    alignment nets from accept_weights.npz."""
    import importlib.util
    import tempfile

    from ransacflow_tpu_torch.cli import generate_pairs
    from ransacflow_tpu_torch.eval import aachen, yfcc
    from ransacflow_tpu_torch.eval.artifacts import load_pair
    from ransacflow_tpu_torch.models.convert import (
        alignment_params_from_tree, init_resnet50_layer3, load_params_npz)
    from ransacflow_tpu_torch.pipeline import CoarseAligner

    t0 = time.perf_counter()
    resnet = init_resnet50_layer3(torch.Generator().manual_seed(0), "cuda")
    align = alignment_params_from_tree(load_params_npz(ACCEPT_WEIGHTS), "cuda")
    no_other = {"warp_sample": 0, "correlation_volume": 0, "ransac_adaptive": 0,
                "lanczos_pyramid": 0, "anchor_resample": 0}
    launches, readings = {}, {}
    with tempfile.TemporaryDirectory() as root:
        pkl, scene, calib = _yfcc_dataset(root)

        # predict: the rotation pre-test, then the loop with a rematch every call
        loops = {}
        for key, n_devices in (("eval_yfcc", None), ("eval_yfcc_device", 1)):
            pred = f"{root}/pred_{key}"
            (_, predict), seconds = _timed(lambda: _launches_of(
                lambda: yfcc.predict_yfcc(pkl, scene, pred, resnet, align, "cuda",
                                          n_devices=n_devices)))
            counts = _check_artifacts(key, pred, n_max=11, extra=("rotation",))
            rotations = [int(load_pair(pred, i)["rotation"]) for i in range(EVAL_PAIRS)]
            require(rotations == [0, 270], f"{key}: the pre-test picked {rotations}")
            # a fresh masked match (K2) and fit (K3) for each of the four rotations and
            # each slot; a fine pass a slot
            _require_launched(f"{key} predict", predict, EVAL_KERNELS,
                              {**no_other, **_per_fine_pass(predict)})
            loops[key] = predict, seconds, counts
        pred = f"{root}/pred_eval_yfcc"
        (errors, accs, results, results_s, calls, cpu_errors, cpu_s, flipped,
         gap) = _yfcc_card_vs_cpu(pred, pkl, scene, calib)
        _require_launched("eval_yfcc results", results,
                          exact={"compose_tail": EVAL_PAIRS, "warp_homography": 0})
        launches["eval_yfcc"] = _add_counts(loops["eval_yfcc"][0], results)
        launches["eval_yfcc_device"] = loops["eval_yfcc_device"][0]
        pose_s = sum(c["s"] for c in calls)
        readings["yfcc"] = {
            "pairs_s": EVAL_PAIRS / loops["eval_yfcc"][1],
            "pairs_s_device_loop": EVAL_PAIRS / loops["eval_yfcc_device"][1],
            "homographies": loops["eval_yfcc"][2],
            "homographies_device_loop": loops["eval_yfcc_device"][2],
            "results_ms_per_pair": results_s * 1e3 / EVAL_PAIRS,
            "pose_host_share": pose_s / results_s,
            "pose_s": [c["s"] for c in calls], "pose_points": [len(c["n1"]) for c in calls],
            "pose_minimal_sets": [c["sets"] for c in calls],
            "cpu_results_ms_per_pair": cpu_s * 1e3 / EVAL_PAIRS,
            "errors_deg": errors, "cpu_errors_deg": cpu_errors, "accs": accs,
            "card_vs_cpu_deg": gap, "flipped_px": flipped,
            "h5py_on_this_machine": importlib.util.find_spec("h5py") is not None}
        r = readings["yfcc"]
        print(f"(j) YFCC, {EVAL_PAIRS} pairs of 640x480 (7 scales, 10k, rematch, cycle match, "
              f"pair 1's target turned by 90): predict {r['pairs_s']:.3f} pairs/s host loop "
              f"({loops['eval_yfcc'][1]:.2f} s), {r['pairs_s_device_loop']:.3f} device loop; "
              f"homographies {r['homographies']} / {r['homographies_device_loop']}; results "
              f"{r['results_ms_per_pair']:.1f} ms a pair, the pose estimator "
              f"{r['pose_host_share']:.3f} of it ({r['pose_s']} s on {r['pose_points']} points, "
              f"{r['pose_minimal_sets']} minimal sets solved); CPU results "
              f"{r['cpu_results_ms_per_pair']:.1f} ms a pair; errors {errors} deg (CPU "
              f"{cpu_errors}), card vs CPU {gap} deg, {flipped} pixels flip at th; accs {accs}; "
              f"h5py here: {r['h5py_on_this_machine']}; launches predict "
              f"{loops['eval_yfcc'][0]}, device loop {loops['eval_yfcc_device'][0]}, results "
              f"{results} on {card}", flush=True)

        # the Aachen export: one pair, the host loop with cached matching
        coarse = CoarseAligner(resnet, "cuda", nb_scale=7, n_iter=N_ITER, min_size=TARGET_HW[0])
        (corr, export), export_s = _timed(lambda: _launches_of(
            lambda: aachen.export_correspondences(coarse, align, f"{scene}/im0.png",
                                                  f"{scene}/im1.png")))
        require(corr is not None and np.isfinite(corr["query_xy"]).all(),
                "Aachen export: no alignment or non-finite points")
        aachen.write_match_file(f"{root}/aachen/matches.txt", "im0_im1", corr)
        with open(f"{root}/aachen/matches.txt") as f:
            require(len(f.read().splitlines()) == len(corr["query_xy"]) + 1,
                    "Aachen export: the match file's rows")
        # the cached match (K2) once; a fine pass a homography, then one K8 for them all
        fine = export["compose_tail"] - 1
        _require_launched("eval_aachen", export, EVAL_KERNELS, {
            **no_other, "mutual_argmax": 1, "warp_homography": fine, "correlation_pair": fine,
            "head_epilogues": fine})
        launches["eval_aachen"] = export
        readings["aachen"] = {"ms_per_pair": export_s * 1e3, "points": len(corr["query_xy"])}
        print(f"(j) Aachen export, 1 pair: {export_s * 1e3:.1f} ms, "
              f"{len(corr['query_xy'])} correspondences; launches {export}", flush=True)

        # generate_pairs: the planted shift kept, a noise / flat pair rejected
        rng = np.random.RandomState(17)
        _to_pil(rng.rand(*TARGET_HW, 3)).save(f"{root}/noise.png")
        _to_pil(np.full((*TARGET_HW, 3), 0.5)).save(f"{root}/flat.png")
        _write_csv(f"{root}/pairs.csv", [{"imgA": f"{scene}/im0.png", "imgB": f"{scene}/im1.png"},
                                         {"imgA": f"{root}/noise.png",
                                          "imgB": f"{root}/flat.png"}])
        inliers = []
        align_pair = generate_pairs.align_pair
        generate_pairs.align_pair = lambda *a: (lambda out: inliers.append(out[0]) or out)(
            align_pair(*a))
        try:
            (_, generate), generate_s = _timed(lambda: _launches_of(
                lambda: generate_pairs.main(["--pairCSV", f"{root}/pairs.csv", "--imgDir", "/",
                                             "--outDir", f"{root}/train_pairs",
                                             "--device", "cuda"])))
        finally:
            generate_pairs.align_pair = align_pair
        written = sorted(os.listdir(f"{root}/train_pairs"))
        require(written == ["0_1.jpg", "0_2.jpg"], f"generate_pairs wrote {written}; "
                                                   f"inliers {inliers}")
        _require_launched("generate_pairs", generate, exact={
            **no_other, "mutual_argmax": 2, "ransac_score": 2, "warp_homography": 1,
            "compose_tail": 0})
        launches["generate_pairs"] = generate
        readings["generate_pairs"] = {"pairs_s": 2 / generate_s, "inliers": inliers}
        print(f"(j) generate_pairs, 2 rows at minSize 480 (x0.5, x1, x2 bank): "
              f"{2 / generate_s:.3f} rows/s ({generate_s:.2f} s), inliers {inliers} (kept > 50); "
              f"launches {generate} on {card}; phase (j) {time.perf_counter() - t0:.1f} s",
              flush=True)
    return launches, readings


# ---------------------------------------------------------------------------
# (k) affine fits, iterative refinement, MegaDepth validation, --nativeResize
# ---------------------------------------------------------------------------

REFINE_HW = TARGET_HW  # refine's H x W grid of matches: 307,200
REFINE_N_ITER = 1000   # refine_flow_ransac's default
H_REFINE = np.array([[0.95, 0.03, 0.02], [-0.02, 0.92, -0.03], [0.01, -0.02, 1.0]],
                    np.float32)
A_SERVING = np.array([[1.05, 0.02, 0.03], [-0.01, 0.97, -0.02], [0.0, 0.0, 1.0]],
                     np.float32)
VAL_THETAS = (np.array([[0.8, 0.0, 0.1], [0.0, 0.9, -0.05]], np.float32),
              np.array([[1.0, 0.05, -0.1], [0.02, 0.85, 0.0]], np.float32))
VAL_DELTAS = np.array([0.5, 2.5, 4.0, 6.0, 10.0, 20.0, 30.0, 100.0])
VAL_KERNELS = ("warp_sample", "blur_pool", "correlation_volume", "head_epilogues")
REFINE_KERNELS = ("ransac_score", "warp_sample", "correlation_pair", "head_epilogues",
                  "compose_tail", "blur_pool")


def _affine_matches(gen, inlier_frac=0.6):
    """The serving shape's 1200 target cells under a known affine map,
    `inlier_frac` of them inliers, 10% invalid (`_ransac_matches` for 3-point
    fits)."""
    from ransacflow_tpu_torch.ops.grid import feature_cell_coords

    y, x = feature_cell_coords(30, 40, "cuda")
    m2 = torch.stack([x, y, torch.ones_like(x)], dim=1)
    m1 = m2 @ torch.from_numpy(A_SERVING).cuda().T
    m1[:, :2] += 0.005 * torch.randn((N_TARGET, 2), generator=gen, device="cuda")
    outlier = torch.rand(N_TARGET, generator=gen, device="cuda") >= inlier_frac
    m1[outlier, :2] = torch.rand((int(outlier.sum()), 2), generator=gen, device="cuda") * 2 - 1
    valid = torch.rand(N_TARGET, generator=gen, device="cuda") > 0.1
    return m1.contiguous(), m2, valid


def _planted_flow(gen, hw=REFINE_HW):
    """refine's inputs at `hw`: the flow of H_REFINE (1, H, W, 2) with a
    corrupted block and an out-of-bounds band, and a matchability (H, W)
    low on a strip."""
    from ransacflow_tpu_torch.ops.homography import warp_grid

    h, w = hw
    flow = warp_grid(torch.from_numpy(H_REFINE).cuda()[None], h, w)
    flow[0, h // 5:h // 2, w // 4:w // 2] += 0.3
    flow[0, :, :w // 10] = 5.0
    match = 0.6 + 0.4 * torch.rand((h, w), generator=gen, device="cuda")
    match[-h // 8:] = 0.2
    return flow.contiguous(), match


def _refine_matches(flow, match, th=0.5):
    """refine_flow_ransac's padded match arrays and gate."""
    from ransacflow_tpu_torch.ops.grid import normalized_grid

    _, h, w, _ = flow.shape
    grid = normalized_grid(h, w, flow.device)
    fx, fy = flow[0, ..., 0], flow[0, ..., 1]
    valid = ((match * ((fx >= -1) & (fx <= 1) & (fy >= -1) & (fy <= 1)).float()) > th)
    ones = torch.ones((h * w, 1), device=flow.device)
    return (torch.cat([flow[0].reshape(-1, 2), ones], 1).contiguous(),
            torch.cat([grid.reshape(-1, 2), ones], 1).contiguous(), valid.reshape(-1))


def _suffixed(out, got, suffix):
    for k, v in got.items():
        out[k + suffix] = v


def _k3_case(m1, m2, valid, n_iter, transform, seed_gen, own, name, reps=20):
    """K3 against its plain version on one seed (sets, winner, counts, mask)
    and timed as the op (seed draw and launch) against the seed draw and
    the plain fit; the kernel alone's device time and the bound."""
    from ransacflow_tpu_torch.kernels.ransac import n_points_of, ransac_fit, ransac_fit_ref
    from ransacflow_tpu_torch.ops.ransac import draw_seed, ransac_homography

    n_points = n_points_of(transform)
    seed = draw_seed(seed_gen, "cuda")
    fit, rec = ransac_fit(m1, m2, valid, 0.05, n_iter, seed=seed, record=True,
                          transform=transform)
    ref, rec_ref = ransac_fit_ref(m1, m2, valid, 0.05, n_iter, seed=seed, transform=transform)
    torch.cuda.synchronize()
    got = _ransac_against_plain(name, fit, rec, ref, rec_ref, m1, m2, valid, transform,
                                atol=1e-5)
    got.update(paired_ms(
        lambda: ransac_homography(m1, m2, valid, 0.05, n_iter, generator=own,
                                  n_points=n_points, transform=transform),
        lambda: ransac_fit_ref(m1, m2, valid, 0.05, n_iter, seed=draw_seed(own, "cuda"),
                               transform=transform), reps=reps))
    got["kernel_device_ms"] = device_ms(
        lambda: ransac_fit(m1, m2, valid, 0.05, n_iter, seed=seed, transform=transform), reps)
    got.update(_ransac_bound(m1, m2, valid, seed, n_iter))
    got.update(library(None))
    got["num_inliers"], got["n_valid"] = int(fit.num_inliers), int(valid.sum())
    return got


def _k4_case(m1, m2, valid, n_iter, chunk, blocks, transform, seed_gen, own, name):
    from ransacflow_tpu_torch.kernels.ransac import n_points_of
    from ransacflow_tpu_torch.kernels.ransac_adaptive import (
        ransac_adaptive, ransac_adaptive_ref)
    from ransacflow_tpu_torch.ops.ransac import draw_seed, ransac_homography_adaptive

    n_points = n_points_of(transform)
    seed = draw_seed(seed_gen, "cuda")
    args = (m1, m2, valid, 0.05, n_iter, chunk, 0.999)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fit, n_eval, rec = ransac_adaptive(*args, seed=seed, record=True, transform=transform)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref, n_eval_r, rec_ref = ransac_adaptive_ref(*args, seed=seed, transform=transform)
    require(int(n_eval) == int(n_eval_r) == blocks * chunk,
            f"{name}: {int(n_eval)} evaluated, plain {int(n_eval_r)}, expected {blocks} blocks")
    got = _ransac_against_plain(name, fit, rec, ref, rec_ref, m1, m2, valid, transform,
                                atol=1e-5)
    got.update(paired_ms(
        lambda: ransac_homography_adaptive(m1, m2, valid, 0.05, n_iter, chunk, generator=own,
                                           n_points=n_points, transform=transform),
        lambda: ransac_adaptive_ref(*args, seed=draw_seed(own, "cuda"), transform=transform),
        reps=5))
    got["kernel_device_ms"] = device_ms(
        lambda: ransac_adaptive(*args, seed=seed, transform=transform), 5)
    got.update(_ransac_bound(m1, m2, valid, seed, blocks * chunk))
    got.update(library(None))
    return got


def check_ransac_affine_and_large():
    """K3 and K4 in their affine form at the serving shape (1200 matches,
    10k hypotheses; K4 in blocks of 4096 to 50k), and past the shared-memory
    order: K3 at refine's shape (307,200 matches, 1,000 hypotheses),
    homography and affine, and one K4 fit there (blocks of 1024). Returns
    ({'ransac_score': ..., 'ransac_adaptive': ...} readings keyed by
    suffix)."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    own = torch.Generator(device="cuda").manual_seed(16)
    k3, k4 = {}, {}
    m1, m2, valid = _affine_matches(gen)
    got = _k3_case(m1, m2, valid, N_ITER, "affine", gen, own, "ransac (affine)")
    require(got["num_inliers"] > 0.4 * N_TARGET, "ransac (affine): no good model found")
    _suffixed(k3, got, "_affine")
    for case, frac, blocks in (("", 0.6, 1), ("_to_cap", 0.0, 13)):
        m1, m2, valid = _affine_matches(gen, frac)
        got = _k4_case(m1, m2, valid, MH_N_ITER, MH_CHUNK, blocks, "affine", gen, own,
                       f"ransac_adaptive (affine{case})")
        _suffixed(k4, got, "_affine" + case)
    m1, m2, valid = _refine_matches(*_planted_flow(gen))
    for transform, suffix in (("homography", "_refine"), ("affine", "_refine_affine")):
        got = _k3_case(m1, m2, valid, REFINE_N_ITER, transform, gen, own,
                       f"ransac ({transform} at refine's shape)", reps=5)
        _suffixed(k3, got, suffix)
    got = _k4_case(m1, m2, valid, 8192, 1024, 1, "homography", gen, own,
                   "ransac_adaptive (refine's shape)")
    _suffixed(k4, got, "_large")
    return {"ransac_score": k3, "ransac_adaptive": k4}


def _small_affine_against_cpu():
    """CoarseAligner(transform='affine') on a small translated pair on the
    card and on the CPU, the same seeded networks and the same 3-cell sets
    (the plain draws under one seed): equal matches, H within 1e-5, equal
    inlier cells."""
    from ransacflow_tpu_torch.kernels.ransac import draw_sets_ref
    from ransacflow_tpu_torch.pipeline import CoarseAligner

    base = _blocky(np.random.RandomState(8), 1, 128, 128)[0]
    src, tgt = _to_pil(base), _to_pil(np.roll(base, (8, 8), axis=(0, 1)))
    out = {}
    for device in ("cpu", "cuda"):
        resnet, _ = _nets(device)
        aligner = CoarseAligner(resnet, device, nb_scale=1, n_iter=512, min_size=128,
                                transform="affine")
        aligner.set_pair(src, tgt)
        valid = aligner._masked_matches(None)[2].cpu()
        sets = draw_sets_ref(valid, torch.tensor([MH_SEED]), 512, n_points=3)
        out[device] = (valid,) + aligner.get_coarse(injected_samples=sets.numpy())
    (vc, hc, ic), (vg, hg, ig) = out["cpu"], out["cuda"]
    require(torch.equal(vc, vg), "affine small pair: the matches differ from the CPU's")
    require(hc is not None and hg is not None, "affine small pair: no model")
    err = float(np.abs(hg - hc).max())
    require(err <= 1e-5 and np.array_equal(ig, ic),
            f"affine small pair: H {err} from the CPU's, inliers equal {np.array_equal(ig, ic)}")
    return {"h_max_abs_err": err, "valid_matches": int(vc.sum()), "inliers": int(ic.sum())}


def _affine_loop(card):
    """The device-resident loop with affine fits on pair 0 of phase (e)'s
    related pairs at the HPatches configuration (7 scales, 50k fixed
    hypotheses, max_coarse 10, mask_region_th 0.01, match12 only): the
    launches of the pair's setup and the loop, seconds of the loop, and the
    host loop on the same aligner and seed against it."""
    from ransacflow_tpu_torch.models.convert import (
        alignment_params_from_tree, init_resnet50_layer3, load_params_npz)
    from ransacflow_tpu_torch.pipeline import (
        CoarseAligner, multi_homography_predict, multi_homography_predict_fused)
    from ransacflow_tpu_torch.utils.image import pyramid_shapes

    srcs, tgts = _related_pairs(np.random.RandomState(1), 1, pyramid_shapes()[0])
    resnet = init_resnet50_layer3(torch.Generator().manual_seed(0), "cuda")
    align = alignment_params_from_tree(load_params_npz(ACCEPT_WEIGHTS), "cuda")
    aligner = CoarseAligner(resnet, "cuda", nb_scale=7, n_iter=MH_N_ITER, min_size=480,
                            transform="affine", seed=MH_SEED)
    kw = dict(max_coarse=MH_MAX_COARSE, mask_region_th=0.01, cycle_match=False)
    run = lambda: multi_homography_predict_fused(  # noqa: E731
        aligner, align, generator=torch.Generator(device="cuda").manual_seed(MH_SEED), **kw)
    # the pair's setup (the trunk and K2's cached matching) and the loop
    fused, launches = _launches_of(
        lambda: (aligner.set_pair(_to_pil(srcs[0]), _to_pil(tgts[0])), run())[1])
    require(fused is not None, "affine loop found nothing")
    n_h = fused["coarse_h"].shape[0]
    require(1 <= n_h <= MH_MAX_COARSE + 1 and np.isfinite(fused["coarse_h"]).all()
            and np.array_equal(fused["coarse_h"][:, 2], np.tile([0.0, 0.0, 1.0], (n_h, 1))),
            f"affine loop: homographies {fused['coarse_h']}")
    _require_launched("affine loop", launches, ("mutual_argmax", "ransac_score"),
                      {"ransac_adaptive": 0, **_per_fine_pass(launches)})
    require(launches["ransac_score"] == launches["warp_homography"],
            f"affine loop: K3 {launches['ransac_score']} a slot run: {launches}")
    seconds = min(_event_ms(run) for _ in range(3)) / 1e3
    host = multi_homography_predict(aligner, align, **kw)
    gap = _h_error(host["coarse_h"][0], fused["coarse_h"][0])
    require(gap < 0.01, f"affine loop: the host loop's first H is {gap} from the device's")
    shift = np.array([[1, 0, -32 / 639], [0, 1, -32 / 479], [0, 0, 1]])
    return launches, {"seconds": seconds, "homographies": n_h, "host_gap": gap,
                      "first_h": fused["coarse_h"][0].tolist(),
                      "first_h_from_roll": _h_error(fused["coarse_h"][0], shift)}


def _refine_card_vs_cpu():
    """refine_flow_ransac at 480x640 on the planted flow: the card's fit
    (its draws from a CUDA generator) against the CPU's plain path on the
    sets those draws give (`draw_sets_ref` under the seed the card drew):
    found and count equal, refined_h within 1e-5, the fine outputs within
    1e-3; launches of one call; seconds a call."""
    from ransacflow_tpu_torch.kernels.ransac import draw_sets_ref
    from ransacflow_tpu_torch.models.convert import alignment_params_from_tree, load_params_npz
    from ransacflow_tpu_torch.ops.homography import warp_grid
    from ransacflow_tpu_torch.ops.ransac import draw_seed
    from ransacflow_tpu_torch.pipeline import fine_features, refine_flow_ransac

    flow, match = _planted_flow(torch.Generator(device="cuda").manual_seed(21))
    srcs, tgts = _related_pairs(np.random.RandomState(2), 1, REFINE_HW)
    tree = load_params_npz(ACCEPT_WEIGHTS)
    outs = {}
    for device in ("cuda", "cpu"):
        align = alignment_params_from_tree(tree, device)
        src, featt = (torch.from_numpy(a).to(device) for a in (srcs, tgts))
        featt = fine_features(align, featt)
        f, m = flow.to(device), match.to(device)
        if device == "cuda":
            gen = torch.Generator(device="cuda").manual_seed(22)
            twin = torch.Generator(device="cuda")
            twin.set_state(gen.get_state())
            seed = draw_seed(twin, "cuda").cpu()  # the seed the call draws
            call = lambda: refine_flow_ransac(gen, align, src, featt, f, m)  # noqa: E731
            outs[device], launches = _launches_of(call)
            gen.manual_seed(22)
            ms = min(_event_ms(call) for _ in range(3))
        else:
            valid = _refine_matches(f, m)[2]
            sets = draw_sets_ref(valid, seed, REFINE_N_ITER)
            t0 = time.perf_counter()
            outs[device] = refine_flow_ransac(None, align, src, featt, f, m,
                                              injected_samples=sets)
            cpu_s = time.perf_counter() - t0
    gpu, cpu = ({k: v.cpu() for k, v in outs[d].items()} for d in ("cuda", "cpu"))
    require(bool(gpu["found"]) and bool(cpu["found"]), "refine: no model")
    require(int(gpu["num_inliers"]) == int(cpu["num_inliers"]),
            f"refine: {int(gpu['num_inliers'])} inliers, CPU {int(cpu['num_inliers'])}")
    norm = lambda h: (h / h[2, 2]).double()  # noqa: E731
    h_err = (norm(gpu["refined_h"]) - norm(cpu["refined_h"])).abs().max().item()
    require(h_err <= 1e-5, f"refine: refined_h {h_err} from the CPU's")
    fine_err = {k: (gpu[k] - cpu[k]).abs().max().item()
                for k in ("flow", "match", "flow_down8", "match_down8")}
    require(max(fine_err.values()) <= 1e-3, f"refine: fine outputs {fine_err}")
    truth = warp_grid(torch.from_numpy(H_REFINE)[None].double(), 8, 8)
    fit = warp_grid(norm(gpu["refined_h"])[None], 8, 8)
    _require_launched("refine", launches, REFINE_KERNELS,
                      {"ransac_score": 1, "ransac_adaptive": 0, "warp_homography": 0,
                       "warp_sample": 1, "correlation_volume": 0})
    return launches, {"ms": ms, "cpu_s": cpu_s, "refined_h_err": h_err, "fine_err": fine_err,
                      "num_inliers": int(gpu["num_inliers"]),
                      "n_valid": int(_refine_matches(flow, match)[2].sum()),
                      "grid_from_truth": (fit - truth).abs().max().item()}


def _write_val_set(root, rng, hw=REFINE_HW, n_points=40):
    """A MegaDepth-style validation set (tests/test_torch_validation.py's
    plan at `hw`): one scene, two rows, planted pixel offsets under the
    fixed coarse affines, each planted error 0.05 px clear of every
    threshold. Returns (csv, image dir, coarse .pkl, planted precision)."""
    import csv
    import pickle

    from PIL import Image

    from ransacflow_tpu_torch.train.validation import PIXEL_GRID

    scene = os.path.join(root, "val", "0")
    os.makedirs(scene)
    h, w = hw
    for name in ("s", "t"):
        Image.fromarray((_blocky(rng, 1, h, w)[0] * 255).astype(np.uint8)).save(
            os.path.join(scene, f"{name}.jpg"))
    rows, hits = [], np.zeros(8)
    for theta, delta in zip(VAL_THETAS, (VAL_DELTAS, np.full(1, 0.2))):
        # candidate target pixels on a diagonal; the first n_points whose
        # error (int()-truncated source coordinates) is clear of every
        # threshold by 0.05 px are kept
        xb = np.linspace(8, w - 9, 8 * n_points).round()
        yb = np.linspace(8, h - 9, 8 * n_points).round()
        xn, yn = 2.0 * xb / (w - 1) - 1.0, 2.0 * yb / (h - 1) - 1.0
        sx = (theta[0, 0] * xn + theta[0, 1] * yn + theta[0, 2] + 1) * 0.5 * (w - 1)
        sy = (theta[1, 0] * xn + theta[1, 1] * yn + theta[1, 2] + 1) * 0.5 * (h - 1)
        xa = sx + np.resize(delta, len(sx))
        err = np.sqrt((sx - xa.astype(int)) ** 2 + (sy - sy.astype(int)) ** 2)
        keep = np.flatnonzero(np.abs(err[:, None] - PIXEL_GRID[None]).min(1) > 0.05)
        require(len(keep) >= n_points, "val set: too few points clear of the thresholds")
        keep = keep[:n_points]
        xb, yb, xa, sy, err = xb[keep], yb[keep], xa[keep], sy[keep], err[keep]
        hits += (err[:, None] < PIXEL_GRID[None]).sum(0)
        rows.append({"scene": "0", "source_image": "s.jpg", "target_image": "t.jpg",
                     "XA": ";".join(f"{v:.6f}" for v in xa),
                     "YA": ";".join(f"{v:.6f}" for v in sy),
                     "XB": ";".join(f"{v:.0f}" for v in xb),
                     "YB": ";".join(f"{v:.0f}" for v in yb)})
    csv_path, pkl_path = os.path.join(root, "val.csv"), os.path.join(root, "coarse.pkl")
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    with open(pkl_path, "wb") as f:
        pickle.dump(list(VAL_THETAS), f)
    return csv_path, os.path.join(root, "val"), pkl_path, hits / (2 * n_points)


def _zero_flow_nets(device):
    """Seeded alignment networks whose fine residual flow is exactly 0
    (netFlowCoarse.conv4 zeroed): the fine grid is the coarse affine."""
    from ransacflow_tpu_torch.pipeline import init_alignment_params

    nets = init_alignment_params(torch.Generator().manual_seed(1), device)
    with torch.no_grad():
        nets["netFlowCoarse"].conv4.weight.zero_()
    return nets


def _validation_card_vs_cpu(tmp):
    """`validate` on 480x640 images at val_min_size 480: zero-flow networks
    on the card and on the CPU give the planted precision; with the accept
    weights the fine grids of the card and the CPU within 1e-3; launches of
    the 2 rows; seconds a row."""
    import pickle

    from PIL import Image

    from ransacflow_tpu_torch.eval.table import read_rows
    from ransacflow_tpu_torch.models.convert import alignment_params_from_tree, load_params_npz
    from ransacflow_tpu_torch.train.validation import fine_forward, validate

    csv_path, val_dir, pkl_path, planted = _write_val_set(tmp, np.random.RandomState(9))
    rows = read_rows(csv_path)
    with open(pkl_path, "rb") as f:
        thetas = pickle.load(f)
    precs = {}
    for device in ("cuda", "cpu"):
        nets = _zero_flow_nets(device)
        call = lambda: validate(rows, val_dir, thetas, nets, device)  # noqa: E731
        if device == "cuda":
            precs[device], launches = _launches_of(call)
            seconds = min(_event_ms(call) for _ in range(3)) / 1e3
        else:
            t0 = time.perf_counter()
            precs[device] = call()
            cpu_s = time.perf_counter() - t0
    require(np.array_equal(precs["cuda"], precs["cpu"]) and np.array_equal(precs["cuda"], planted),
            f"validation: card {precs['cuda']}, CPU {precs['cpu']}, planted {planted}")
    _require_launched("validation", launches, VAL_KERNELS,
                      {"warp_sample": 2 * len(rows), "correlation_volume": len(rows),
                       "head_epilogues": len(rows), "blur_pool": 6 * len(rows),
                       "ransac_score": 0, "ransac_adaptive": 0, "correlation_pair": 0})
    tree = load_params_npz(ACCEPT_WEIGHTS)
    grids = {}
    for device in ("cuda", "cpu"):
        nets = alignment_params_from_tree(tree, device)
        img = lambda n: torch.from_numpy(np.asarray(  # noqa: E731
            Image.open(os.path.join(val_dir, "0", n)), np.float32) / 255)[None].to(device)
        with torch.inference_mode():
            grids[device] = fine_forward(nets, img("s.jpg"), img("t.jpg"),
                                         torch.from_numpy(thetas[0])[None].to(device)).cpu()
    grid_err = (grids["cuda"] - grids["cpu"]).abs().max().item()
    require(grid_err <= 1e-3, f"validation: the fine grid is {grid_err} from the CPU's")
    return launches, {"prec": precs["cuda"].tolist(), "s_per_row": seconds / len(rows),
                      "cpu_s_per_row": cpu_s / len(rows), "grid_err": grid_err}


def _train_cli_val(tmp):
    """`python -m ransacflow_tpu_torch.cli.train --stage 3 ... --nativeResize
    valMegaDepth ...` for 1 epoch of 2 steps at full width (16 pairs of
    224x224), warm-started from zero-flow networks; the best model must be
    written as BestModel@8_*."""
    from PIL import Image

    from ransacflow_tpu_torch.train import save_checkpoint

    data, out = f"{tmp}/train", f"{tmp}/run"
    os.makedirs(data)
    rng = np.random.RandomState(10)
    for idx in range(2 * TRAIN_PAIRS):
        base = (_blocky(rng, 1, 256, 320)[0] * 255).astype(np.uint8)
        for view, shift in ((1, 0), (2, 6)):
            Image.fromarray(np.roll(base, shift, axis=1)).save(f"{data}/{idx}_{view}.jpg")
    csv_path, val_dir, pkl_path, planted = _write_val_set(f"{tmp}/valset", rng)
    resume = f"{tmp}/zero_flow.pt"
    save_checkpoint(resume, _zero_flow_nets("cpu"))
    cmd = [sys.executable, "-m", "ransacflow_tpu_torch.cli.train", "--trainImgDir", data,
           "--outDir", out, "--stage", "3", "--batchSize", str(TRAIN_PAIRS),
           "--imgSize", str(TRAIN_IMG), "--margin", str(TRAIN_MARGIN), "--nEpochs", "1",
           "--maxStepsPerEpoch", "2", "--device", "cuda", "--resumePth", resume,
           "--nativeResize", "valMegaDepth", "--valImgDir", val_dir, "--valCSV", csv_path,
           "--inPklCoarse", pkl_path, "--valMinSize", "480"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0, f"cli.train valMegaDepth exited {proc.returncode}:\n"
                                  f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    best = [p for p in os.listdir(out) if p.startswith("BestModel@8_")]
    last = [json.loads(line) for line in open(f"{out}/metrics.jsonl")][-1]
    require(len(best) == 1 and last["step"] == 0 and last["val_prec8"] > 0
            and all(np.isfinite(last[k]) for k in ("loss", "loss_lr", "loss_match")),
            f"cli.train valMegaDepth: {os.listdir(out)}, epoch record {last}")
    return {"seconds": seconds, "best": best[0], "val_prec8": last["val_prec8"],
            "planted_prec8": float(planted[4]), "epoch_record": last}


def phase_affine_refine(card, results):
    """(k): K3 and K4 in their affine and large-N forms against their plain
    versions (their readings join the kernels' rows under suffixes), then
    the paths: `CoarseAligner(transform='affine')` (a small pair against the
    CPU; the device loop at the HPatches configuration), refine at 480x640,
    validation on 480x640 images and the training CLI with valMegaDepth and
    --nativeResize."""
    import tempfile

    t0 = time.perf_counter()
    for name, got in check_ransac_affine_and_large().items():
        for key in [k for k in got if k.startswith("bound_ms")]:
            dev = got.get("device_ms" + key[len("bound_ms"):])
            got["share" + key[len("bound_ms"):]] = got[key] / dev if dev else None
        results[name]["max_abs_err"] = max(
            [results[name]["max_abs_err"]]
            + [v for k, v in got.items() if k.startswith("max_abs_err")])
        results[name].update(got)
        print(f"(k) {name}: " + ", ".join(f"{k}={v}" for k, v in got.items()), flush=True)
    small = _small_affine_against_cpu()
    print(f"(k) affine small pair, card vs CPU: {small}", flush=True)
    paths, readings = {}, {"small_pair": small}
    paths["affine_multihomo"], readings["affine_loop"] = _affine_loop(card)
    print(f"(k) affine device loop at the HPatches configuration: "
          f"{readings['affine_loop']}; launches {paths['affine_multihomo']} on {card}",
          flush=True)
    paths["refine"], readings["refine"] = _refine_card_vs_cpu()
    print(f"(k) refine_flow_ransac at 480x640: {readings['refine']}; launches "
          f"{paths['refine']} on {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        paths["validation"], readings["validation"] = _validation_card_vs_cpu(tmp)
        print(f"(k) validate, 2 rows of 480x640: {readings['validation']}; launches "
              f"{paths['validation']} on {card}", flush=True)
        readings["train_cli_val"] = _train_cli_val(tmp)
    print(f"(k) cli.train --nativeResize valMegaDepth, 2 steps at full width: "
          f"{readings['train_cli_val']}; phase (k) {time.perf_counter() - t0:.1f} s",
          flush=True)
    return paths, readings


POOL_SLOTS = ["cuda:0", "cuda:0"]  # a pool of two slots on the one card
# the three routes of the pool's artifacts, held to `--nDevices 1`'s
POOL_ROUTES = {"pool_one": dict(n_devices=1),
               "pool_batched": dict(n_devices=1, batch_pairs=2),
               "pool_two_slots": dict(n_devices=POOL_SLOTS)}
# Between routes the artifacts must be equal bit for bit: the slots' copies of
# the networks run the same cuDNN algorithms and every hand kernel is
# deterministic. Were cuDNN to pick other algorithms for a copy, fp32 sums in
# another order would differ by ~1e-6 of the values; POOL_TOL bounds that.
POOL_TOL = 1e-5
# the kernels that bf16 reaches under the eval policy (PERF.md's table)
BF16_EVAL_KERNELS = ("mutual_argmax", "correlation_pair", "head_epilogues", "compose_tail",
                     "blur_pool")
TRAIN_POLICIES = {"fp32": {}, "bf16": dict(compute_dtype="bfloat16"),
                  "remat": dict(remat=True),
                  "bf16_remat": dict(compute_dtype="bfloat16", remat=True)}
TRAIN_TIMED_STEPS = 8


def _artifact_gap(name, dir_a, dir_b, extra=()):
    """The largest difference between two routes' artifacts of the eval
    pairs (0.0: bit for bit), held to POOL_TOL; equal fields, shapes and
    homography counts."""
    from ransacflow_tpu_torch.eval.artifacts import load_pair

    gap = 0.0
    for i in range(EVAL_PAIRS):
        a, b = load_pair(dir_a, i), load_pair(dir_b, i)
        require(a is not None and b is not None and set(a) == set(b),
                f"{name}: pair {i}: artifacts {a and sorted(a)} vs {b and sorted(b)}")
        for key in a:
            require(a[key].shape == b[key].shape,
                    f"{name}: pair {i}: {key} {a[key].shape} vs {b[key].shape}")
            diff = np.abs(a[key].astype(np.float64) - b[key].astype(np.float64))
            gap = max(gap, float(diff.max()) if diff.size else 0.0)
    require(gap <= POOL_TOL, f"{name}: artifacts {gap} apart, above {POOL_TOL}")
    return gap


def _pool_routes(card, root, resnet, align):
    """HPatches (phase (i)'s pairs) and YFCC (phase (j)'s) through the pool's
    three routes, KITTI's thread pool of two slots against its sequential
    pass: each route's artifacts against the first's."""
    from ransacflow_tpu_torch.eval import hpatches, kitti, yfcc

    hp = f"{root}/hpatches"
    pkl, scene, _ = _yfcc_dataset(root)
    launches, readings = {}, {}
    harnesses = {
        "hpatches": (lambda out, kw: hpatches.predict_hpatches(
            hp, hp, out, resnet, align, "cuda", scenes=(2,), **kw), "2", ()),
        "yfcc": (lambda out, kw: yfcc.predict_yfcc(pkl, scene, out, resnet, align, "cuda",
                                                   **kw), "", ("rotation",)),
    }
    for harness, (predict, sub, extra) in harnesses.items():
        gaps, seconds = {}, {}
        for route, kw in POOL_ROUTES.items():
            out = f"{root}/{harness}_{route}"
            (_, got), seconds[route] = _timed(lambda: _launches_of(lambda: predict(out, kw)))
            _check_artifacts(f"{harness} {route}", f"{out}/{sub}", n_max=11, extra=extra)
            _require_launched(f"{harness} {route}", got, EVAL_KERNELS,
                              {"lanczos_pyramid": 0, **_per_fine_pass(got)})
            launches[f"{harness}_{route}"] = got
            gaps[route] = _artifact_gap(f"{harness} {route}", f"{root}/{harness}_pool_one/{sub}",
                                        f"{out}/{sub}")
        readings[harness] = {"max_abs_diff": gaps, "pairs_s": {
            r: EVAL_PAIRS / t for r, t in seconds.items()}}
        print(f"(l) {harness} predict through --nDevices 1, --nDevices 1 --batchPairs 2 and "
              f"a pool of 2 slots on cuda:0: artifacts apart by {gaps} (0.0: bit for bit), "
              f"pairs/s {readings[harness]['pairs_s']}; launches "
              f"{ {r: launches[f'{harness}_{r}']['compose_tail'] for r in POOL_ROUTES} } "
              f"compose_tail on {card}", flush=True)

    kt = f"{root}/kitti/image_2"
    (_, seq), seq_s = _timed(lambda: _launches_of(lambda: kitti.predict_kitti(
        kt, f"{root}/kitti_seq", resnet, align, "cuda", end_index=EVAL_PAIRS)))
    (_, pool), pool_s = _timed(lambda: _launches_of(lambda: kitti.pooled_kitti_predict(
        kt, f"{root}/kitti_pool", resnet, align, POOL_SLOTS, end_index=EVAL_PAIRS)))
    _check_artifacts("kitti pool", f"{root}/kitti_pool", extra=("fine_flow_d2_down8",))
    gap = _artifact_gap("kitti pool", f"{root}/kitti_seq", f"{root}/kitti_pool")
    require(seq == pool, f"kitti pool: launches {pool}, the sequential pass's {seq}")
    launches["kitti_pool_two_slots"] = pool
    readings["kitti"] = {"max_abs_diff": gap, "pairs_s": {"sequential": EVAL_PAIRS / seq_s,
                                                          "pool_two_slots": EVAL_PAIRS / pool_s}}
    print(f"(l) KITTI predict, a thread pool of 2 slots on cuda:0 against the sequential "
          f"pass: artifacts apart by {gap}, the same launches {pool}; pairs/s "
          f"{readings['kitti']['pairs_s']} on {card}", flush=True)
    return launches, readings


def _best_ms(fn, reps=3):
    """The best of `reps` CUDA-event times of fn() (ms)."""
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def _mfu(flops_per_pair, pairs_s, dtype):
    """Model FLOPs per second over the card's dense peak for `dtype`
    (`utils.flops.peak_flops`), or None for a card the table lacks."""
    from ransacflow_tpu_torch.utils.flops import peak_flops

    peak = peak_flops(torch.cuda.get_device_name(0), dtype)
    return None if peak is None else flops_per_pair * pairs_s / peak


def _loop_flops(shapes, n_evaluated):
    """Model FLOPs of one pair of the device loop (`utils.flops`' counts):
    the bank and target trunks, the cached matching GEMM and the target's
    fine features once, then each slot run (n_evaluated > 0): its RANSAC
    hypotheses, the warped source's fine features, both correlations and
    the three heads."""
    from ransacflow_tpu_torch.utils import flops

    ht, wt = TARGET_HW
    h8, w8 = ht // 8, wt // 8
    n_target = (ht // 16) * (wt // 16)
    total = sum(flops.resnet50_layer3_flops(h, w) for h, w in shapes)
    total += flops.resnet50_layer3_flops(ht, wt) + flops.feature_extractor_flops(ht, wt)
    total += flops.matching_flops(sum((h // 16) * (w // 16) for h, w in shapes), n_target)
    for n in n_evaluated:
        if n > 0:
            total += (flops.ransac_flops(n_target, n) + flops.feature_extractor_flops(ht, wt)
                      + 2 * flops.correlation_flops(h8, w8) + flops.head_flops(h8, w8)
                      + 2 * flops.head_flops(h8, w8, 7, 1))
    return total


def _cast_costs(card):
    """What the boundary casts cost at the eval path's shapes: each wrapper
    on bf16 inputs (upcast, the fp32 kernel, outputs rounded where the
    reference returns bf16) against the same wrapper on the fp32 upcasts,
    CUDA events around 20 calls (host included) and the profiler's device
    time; and the matching GEMM in fp32 (TF32 off) against bf16 with an fp32
    score, which the eval policy runs instead."""
    from ransacflow_tpu_torch.kernels.anchor_resample import anchor_resample_bank
    from ransacflow_tpu_torch.kernels.blurpool import binomial_filter, blur_pool
    from ransacflow_tpu_torch.kernels.compose import compose_tail
    from ransacflow_tpu_torch.kernels.correlation import correlation_pair
    from ransacflow_tpu_torch.kernels.heads import head_epilogues
    from ransacflow_tpu_torch.ops.homography import warp_grid
    from ransacflow_tpu_torch.ops.matching import score_gemm
    from ransacflow_tpu_torch.pipeline.bank import nearest_anchors
    from ransacflow_tpu_torch.utils.image import pyramid_shapes

    gen = torch.Generator(device="cuda").manual_seed(21)
    b16 = torch.bfloat16

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")).to(b16)

    h8, w8 = TARGET_HW[0] // 8, TARGET_HW[1] // 8
    shapes = pyramid_shapes()
    nearest = nearest_anchors(shapes, 3)
    grid = warp_grid(torch.eye(3, device="cuda")[None], *TARGET_HW).contiguous()
    blur_in = rand(1, 64, TARGET_HW[0] - 1, TARGET_HW[1] - 1).contiguous(
        memory_format=torch.channels_last)
    cases = {
        "correlation_pair": (lambda a: correlation_pair(*a, 7),
                             [rand(1, h8, w8, 256, scale=0.06), rand(1, h8, w8, 256, scale=0.06)]),
        "head_epilogues": (lambda a: head_epilogues(*a, 7),
                           [rand(1, h8, w8, 49, scale=3), rand(1, h8, w8, 1, scale=3),
                            rand(1, h8, w8, 1, scale=3)]),
        "compose_tail": (lambda a: compose_tail(*a, True),
                         [rand(1, h8, w8, 2, scale=0.02),
                          torch.rand((1, h8, w8, 1), generator=gen, device="cuda").to(b16),
                          torch.rand((1, h8, w8, 1), generator=gen, device="cuda").to(b16),
                          grid]),
        "blur_pool": (lambda a: blur_pool(a[0], a[1]),
                      [blur_in, binomial_filter(64, 3, "cuda").to(b16)]),
        "anchor_resample": (lambda a: anchor_resample_bank(dict(enumerate(a)), shapes, nearest),
                            [rand(1, h // 16, w // 16, N_CHANNELS) for h, w in shapes]),
    }
    out = {}
    for name, (fn, args) in cases.items():
        up = [a.float() for a in args]
        got, want = fn(args), fn(up)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            require(g.dtype in (torch.float32, b16) and bool(torch.isfinite(g).all()),
                    f"{name}: bf16 output")
            require((g.float() - w.to(g.dtype).float()).abs().max().item()
                    <= 2 ** -7 * w.abs().max().item() + 1e-5,
                    f"{name}: the bf16 call is not the fp32 call's rounding")
        k1, f1, f2, k2 = (cuda_ms(lambda: fn(a)) for a in (args, up, up, args))
        out[name] = {"bf16_ms": (k1 + k2) / 2, "fp32_ms": (f1 + f2) / 2,
                     "bf16_device_ms": device_ms(lambda: fn(args)),
                     "fp32_device_ms": device_ms(lambda: fn(up))}
        row = out[name]
        if row["bf16_device_ms"] is not None and row["fp32_device_ms"] is not None:
            row["cast_device_ms"] = row["bf16_device_ms"] - row["fp32_device_ms"]
    bank = torch.randn((N_CHANNELS, N_BANK), generator=gen, device="cuda")
    featt = torch.randn((N_CHANNELS, N_TARGET), generator=gen, device="cuda")
    f32, fb = (bank, featt), (bank.to(b16), featt.to(b16))
    out["matching_gemm"] = {"fp32_ms": cuda_ms(lambda: score_gemm(*f32)),
                            "bf16_fp32_out_ms": cuda_ms(lambda: score_gemm(*fb)),
                            "fp32_device_ms": device_ms(lambda: score_gemm(*f32)),
                            "bf16_fp32_out_device_ms": device_ms(lambda: score_gemm(*fb))}
    require(score_gemm(*fb).dtype == torch.float32, "the bf16 GEMM's score is not fp32")
    print(f"(l) the boundary casts at the eval path's shapes (bf16 inputs against their fp32 "
          f"upcasts, ms a call): {out} on {card}", flush=True)
    return out


def _bf16_alignment(card, resnet, align):
    """The serving path and the device loop on phase (e)'s 4 related pairs
    at the headline shape, fp32 and bf16 (the eval policy) timed in turns
    (fp32, bf16, bf16, fp32; the best of each dtype's two): pairs/s, MFU,
    homographies, the device split of a call (profiled last);
    each bf16 H against fp32's within JAX's tests' tolerances; and one bf16
    serving call in the anchor mode (K12 on bf16 maps)."""
    from ransacflow_tpu_torch.cli.common import cast_for_dtype
    from ransacflow_tpu_torch.pipeline.fused import device_pyramid, fused_align_batch
    from ransacflow_tpu_torch.utils.flops import fused_align_flops
    from ransacflow_tpu_torch.utils.image import pyramid_shapes

    shapes = pyramid_shapes()
    srcs_np, tgts_np = _related_pairs(np.random.RandomState(1), N_PAIRS, shapes[0])
    sources = torch.from_numpy(srcs_np).cuda()
    targets = torch.from_numpy(tgts_np).cuda()[:, None]
    nets = {"fp32": (resnet, align),
            "bf16": (cast_for_dtype(resnet, "bfloat16"), cast_for_dtype(align, "bfloat16"))}
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}

    def serve(key, **mode):
        r, a = nets[key]
        pyramids = tuple(p[:, None] for p in device_pyramid(sources, shapes))
        return fused_align_batch(r, a, pyramids, targets,
                                 torch.Generator(device="cuda").manual_seed(2),
                                 n_iter=N_ITER, **mode)

    def loop(key):
        return _loop_batch(*nets[key], sources[:, None], targets, shapes, MH_CHUNK)

    launches, outs = {}, {}
    flops = fused_align_flops(shapes, TARGET_HW, n_iter=N_ITER)
    readings = {"flops_per_pair": flops}
    for path, fn in (("serving", serve), ("multihomo", loop)):
        for key in nets:
            outs[path, key], launches[f"{path}_{key}"] = _launches_of(lambda: fn(key))
        _require_launched(f"bf16 {path}", launches[f"{path}_bf16"], BF16_EVAL_KERNELS,
                          _per_fine_pass(launches[f"{path}_bf16"]))
        ms = {key: [] for key in nets}
        for key in ("fp32", "bf16", "bf16", "fp32"):
            ms[key].append(_best_ms(lambda: fn(key), reps=1))
        for key in nets:
            best = min(ms[key])
            pairs_s = N_PAIRS / (best / 1e3)
            out = outs[path, key]
            reading = {"pairs_s": pairs_s, "best_ms": best, "ms_in_turns": ms[key]}
            if path == "serving":
                reading["mfu"] = _mfu(flops["total"], pairs_s, dtypes[key])
                reading["found"] = out["found"].tolist()
                reading["inliers"] = out["num_inliers"].tolist()
            else:
                reading["homographies"] = out["count"].tolist()
                reading["avg_homographies"] = float(np.mean(reading["homographies"]))
                loop_flops = sum(_loop_flops(shapes, row)
                                 for row in out["n_evaluated"].tolist())
                reading["mfu"] = _mfu(loop_flops / N_PAIRS, pairs_s, dtypes[key])
            readings[f"{path}_{key}"] = reading
        if path == "serving":
            h32, h16 = (outs[path, k]["H21"].double().cpu().numpy() for k in ("fp32", "bf16"))
            gap = float(np.abs(h16 / h16[:, 2:, 2:] - h32 / h32[:, 2:, 2:]).max())
            require(all(readings["serving_bf16"]["found"]) and gap <= 0.05,
                    f"bf16 serving: H21 {gap} from fp32's (JAX's tolerance 0.05), found "
                    f"{readings['serving_bf16']['found']}")
        else:
            gap = max(_h_error(outs[path, "bf16"]["hs"][k, 0].cpu().numpy(),
                               outs[path, "fp32"]["hs"][k, 0].cpu().numpy())
                      for k in range(N_PAIRS))
            require(gap <= 0.01, f"bf16 loop: first H {gap} from fp32's (JAX's 0.01)")
            for key in nets:
                for field in ("hs", "flows", "matches"):
                    require(bool(torch.isfinite(outs[path, key][field]).all()),
                            f"{key} loop: {field} is not finite")
        readings[f"{path}_h_gap"] = gap
        print(f"(l) {path}, {N_PAIRS} related pairs at 480x640 (7 scales; serving 10k "
              f"hypotheses, the loop adaptive blocks of {MH_CHUNK} to {MH_N_ITER}), fp32 vs "
              f"bf16 (the eval policy), best of 2 in turns: "
              f"{ {k: readings[f'{path}_{k}'] for k in nets} }; bf16 H within {gap:.3e} of "
              f"fp32's; launches {launches[f'{path}_bf16']} on {card}", flush=True)
    _, launches["serving_bf16_anchor"] = _launches_of(
        lambda: serve("bf16", anchor_stride=3, relax_cells=1))
    _require_launched("bf16 serving, anchor mode", launches["serving_bf16_anchor"],
                      BF16_EVAL_KERNELS + ("anchor_resample",))
    # the device split last: the profiler slows the host's launches after it
    profiles = {}
    for path, fn in (("serving", serve), ("multihomo", loop)):
        for key in nets:
            prof = _profile_step(lambda: fn(key), reps=1)
            profiles[f"{path}_{key}"] = {
                "device_ms": prof["device_ms"], "families_ms": prof["families_ms"],
                "idle_share": max(0.0, 1.0 - prof["device_ms"]
                                  / readings[f"{path}_{key}"]["best_ms"])}
    readings["profiles"] = profiles
    print(f"(l) the device split of a call, fp32 and bf16: {profiles} on {card}", flush=True)
    return launches, readings


def _train_policies(card):
    """The stage-3 step at full width (16 pairs of 224x224, margin 88) in
    fp32, bf16 (the training policy), with remat and with both, fresh
    networks of one seed each: step 0's loss (bf16 within 5e-3 of fp32's,
    JAX's tests/test_train.py:246-272 tolerance; remat equal to its plain
    step's, loss rtol 1e-6 and BatchNorm statistics rtol 2e-5 / atol 2e-6,
    tests/test_train.py:91-110), fp32 masters after bf16 steps, the median
    step ms of TRAIN_TIMED_STEPS and the peak memory."""
    from ransacflow_tpu_torch.train import train_step

    batch = _train_batch(_related_train_images(np.random.RandomState(6), TRAIN_PAIRS,
                                               TRAIN_IMG).cuda(),
                         TRAIN_PAIRS, TRAIN_IMG, TRAIN_MARGIN)
    launches, readings, firsts = {}, {}, {}
    for name, kw in TRAIN_POLICIES.items():
        nets, opt = _new_trainer("cuda", 3)
        step = lambda: train_step(nets, opt, *batch, **_stage_kwargs(3), **kw)  # noqa: E731
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        first, launches[f"train_{name}"] = _launches_of(step)
        _require_launched(f"train {name}", launches[f"train_{name}"], TRAIN_KERNELS,
                          {"head_epilogues": 2, "head_epilogues_bwd": 2})
        stats = {f"{n}.{k}": b.clone() for n, net in nets.items()
                 for k, b in net.named_buffers() if "running" in k}
        firsts[name] = (float(first["loss"]), stats)
        for _ in range(2):  # warm-up
            step()
        times = []
        for _ in range(TRAIN_TIMED_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = step()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        require(all(np.isfinite(float(v)) for v in metrics.values()),
                f"train {name}: losses {metrics}")
        dtypes = {t.dtype for net in nets.values() for t in net.state_dict().values()
                  if t.is_floating_point()}
        dtypes |= {v.dtype for st in opt.state.values() for v in st.values()
                   if v.is_floating_point()}
        require(dtypes == {torch.float32}, f"train {name}: masters and Adam state {dtypes}")
        step_ms = float(np.median(times))
        readings[name] = {"step_ms": step_ms, "step_ms_min": min(times),
                          "step_ms_max": max(times), "pairs_s": TRAIN_PAIRS / (step_ms / 1e3),
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                          "loss_step0": firsts[name][0]}
        del nets, opt, step
    gaps = {"bf16_vs_fp32_loss": abs(firsts["bf16"][0] - firsts["fp32"][0])}
    require(gaps["bf16_vs_fp32_loss"] < 5e-3,
            f"bf16 step 0's loss {gaps['bf16_vs_fp32_loss']} from fp32's (tolerance 5e-3)")
    for remat, plain in (("remat", "fp32"), ("bf16_remat", "bf16")):
        (la, sa), (lb, sb) = firsts[remat], firsts[plain]
        gaps[f"{remat}_loss_rel"] = abs(la - lb) / abs(lb)
        gaps[f"{remat}_bn_stats"] = max((sa[k] - sb[k]).abs().max().item() for k in sb)
        require(gaps[f"{remat}_loss_rel"] <= 1e-6, f"{remat}: step 0's loss {la}, plain {lb}")
        for k in sb:
            require(torch.allclose(sa[k], sb[k], rtol=2e-5, atol=2e-6),
                    f"{remat}: BatchNorm statistic {k} differs from the plain step's")
    readings["gaps"] = gaps
    print(f"(l) training, stage 3 at full width ({TRAIN_PAIRS} pairs of {TRAIN_IMG}x"
          f"{TRAIN_IMG}), median of {TRAIN_TIMED_STEPS} steps: {readings}; launches "
          f"{launches} on {card}", flush=True)
    return launches, readings


def phase_pool_bf16(card):
    """(l) The pool, --batchPairs, the bf16 policies and remat (see the
    module docstring)."""
    import tempfile

    from ransacflow_tpu_torch.cli import eval_hpatches
    from ransacflow_tpu_torch.eval import hpatches
    from ransacflow_tpu_torch.eval.artifacts import load_pair
    from ransacflow_tpu_torch.models.convert import (
        alignment_params_from_tree, init_resnet50_layer3, load_params_npz)

    t0 = time.perf_counter()
    resnet = init_resnet50_layer3(torch.Generator().manual_seed(0), "cuda")
    align = alignment_params_from_tree(load_params_npz(ACCEPT_WEIGHTS), "cuda")
    with tempfile.TemporaryDirectory() as root:
        _eval_datasets(root)
        paths, readings = _pool_routes(card, root, resnet, align)

        # the CLI reads scenes 2-6: each a link to scene 2's CSV, its first pair
        hp, out = f"{root}/hpatches", f"{root}/hpatches_bf16"
        for scene in hpatches.SCENES[1:]:
            os.link(f"{hp}/hpatches_1_2.csv", f"{hp}/hpatches_1_{scene}.csv")
        (_, predict), seconds = _timed(lambda: _launches_of(lambda: eval_hpatches.main([
            "predict", "--csv-path", hp, "--image-data-path", hp, "--outDir", out,
            "--endIndex", "1", "--device", "cuda", "--computeDtype", "bfloat16"])))
        counts = []
        for scene in hpatches.SCENES:
            art = load_pair(f"{out}/{scene}", 0)
            require(art is not None and all(bool(np.isfinite(a).all()) for a in art.values()),
                    f"hpatches bf16: scene {scene}: artifact {art and sorted(art)}")
            require(art["fine_flow_down8"].dtype == np.float32, "hpatches bf16: artifact dtype")
            counts.append(art["coarse_h"].shape[0])
        _require_launched("hpatches bf16 predict", predict, EVAL_KERNELS + BF16_EVAL_KERNELS,
                          _per_fine_pass(predict))
        paths["eval_hpatches_bf16"] = predict
        readings["hpatches_bf16"] = {"pairs_s": len(hpatches.SCENES) / seconds,
                                     "homographies": counts}
        print(f"(l) `cli.eval_hpatches predict --computeDtype bfloat16` (the host loop at "
              f"its defaults, seeded networks, one pair a scene): {readings['hpatches_bf16']}; "
              f"launches {predict} on {card}", flush=True)

    marks = {"pool_and_bf16_predict": time.perf_counter() - t0}
    got, readings["train"] = _train_policies(card)
    paths.update(got)
    marks["train"] = time.perf_counter() - t0
    got, readings["alignment"] = _bf16_alignment(card, resnet, align)
    paths.update(got)
    marks["alignment"] = time.perf_counter() - t0
    readings["casts"] = _cast_costs(card)
    readings["seconds"] = marks["casts"] = time.perf_counter() - t0
    readings["seconds_at"] = marks
    print(f"(l) phase (l) {readings['seconds']:.1f} s (elapsed after each part: {marks}) "
          f"on {card}", flush=True)
    return paths, readings


# -- (m) multi-card data parallelism ---------------------------------------
DP_KERNELS = TRAIN_KERNELS  # every training kernel, on every rank
SHARD_SLOTS = ["cuda:0", "cuda:0"]  # two slots (ranks) on the one card
MC_CARDS = 4
MC_TIMED_STEPS = 12
MC_SERVE_PAIRS = 32  # bench.py's serving batch


def _dp_images(n_pairs, seed):
    """concat(I1, I2) of `n_pairs` related stage-3 pairs, numpy."""
    return _related_train_images(np.random.RandomState(seed), n_pairs, TRAIN_IMG).numpy()


def _local_rows(n_pairs, rank, world):
    """The rows of concat(I1, I2) that rank `rank` holds as its
    concat(I1_r, I2_r)."""
    b = n_pairs // world
    rows = np.arange(rank * b, (rank + 1) * b)
    return np.concatenate([rows, n_pairs + rows])


def _grad_state(nets):
    return ({f"{n}.{k}": p.grad.cpu() for n, net in nets.items()
             for k, p in net.named_parameters() if p.grad is not None},
            {f"{n}.{k}": b.cpu().float() for n, net in nets.items()
             for k, b in net.named_buffers()})


def _timed_steps(step, reps):
    """Median CUDA-event ms of `reps` steps after 2 of warm-up, and the
    peak memory (GB) from the first of them."""
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), times, torch.cuda.max_memory_allocated() / 1e9


def _collective_ms(step):
    """Device ms of one step and of its collectives (NCCL kernels and gloo's
    copies are not separable from the rest: the NCCL kernels' share), from
    a profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.self_device_time_total > 0]
    return {"device_ms": sum(ms for _, ms in rows),
            "nccl_ms": sum(ms for k, ms in rows if "nccl" in k.lower()),
            "nccl_kernels": sum(1 for k, _ in rows if "nccl" in k.lower())}


def _dp_rank(rank, world, device, images, reps, one_card):
    """One rank of the data-parallel stage-3 step (`train_grads` under the
    default group) on its share of `images`: its launches, losses, reduced
    gradients and BatchNorm statistics; with `reps`, the median step ms
    (`train_step`), peak GB and the collectives' device ms; with
    `one_card`, the step again from fresh replicas (the data-parallel
    step's own run-to-run floor, `grads2`) and K10's global form against
    its plain twin."""
    import torch.distributed as dist

    from ransacflow_tpu_torch import kernels
    from ransacflow_tpu_torch.device import use_full_fp32
    from ransacflow_tpu_torch.train import train_grads, train_step

    use_full_fp32()
    probe = torch.ones(4, device=device)
    dist.all_reduce(probe)  # the backend carries CUDA tensors (gloo: through the host)
    require(bool((probe == world).all()), f"rank {rank}: all_reduce gave {probe.tolist()}")
    n_pairs = len(images) // 2
    b = n_pairs // world
    batch = _train_batch(torch.from_numpy(images[_local_rows(n_pairs, rank, world)]).to(device),
                         b, TRAIN_IMG, TRAIN_MARGIN)
    nets, opt = _new_trainer(device, 3)
    kw = dict(_stage_kwargs(3), group=dist.group.WORLD)
    kernels.reset_launch_counts()
    metrics = train_grads(nets, opt, *batch, **kw)
    torch.cuda.synchronize()
    out = {"launches": kernels.launch_counts(),
           "metrics": {k: float(v) for k, v in metrics.items()}}
    out["grads"], out["bn"] = _grad_state(nets)
    if one_card:
        again, opt2 = _new_trainer(device, 3)
        train_grads(again, opt2, *batch, **kw)
        out["grads2"] = _grad_state(again)[0]
        del again, opt2
        out["ssim"] = _ssim_global_rank(rank, world, device)
    if reps:
        step = lambda: train_step(nets, opt, *batch, **kw)  # noqa: E731
        out["step_ms"], out["step_ms_all"], out["peak_gb"] = _timed_steps(step, reps)
        out["profile"] = _collective_ms(step)
    return out


def _ssim_global_rank(rank, world, device):
    """K10's global form on this rank's half of phase (c)'s training-shape
    inputs, against the plain twin's global form (loss to 1e-5 relative,
    gradient to 1e-4 of its largest magnitude) and against the kernel on
    the whole batch in this process (the loss equal to 1e-5, the gradient
    over `world` to 1e-4: a rank's backward gives world times its share);
    timed with the all-reduces (keys `_global`)."""
    import torch.distributed as dist

    from ransacflow_tpu_torch.kernels.ssim import masked_ssim_loss, masked_ssim_loss_ref

    group = dist.group.WORLD
    gen = torch.Generator(device=device).manual_seed(21)
    b2 = 2 * TRAIN_PAIRS
    img1 = torch.rand((b2, TRAIN_IMG, TRAIN_IMG, 3), generator=gen, device=device)
    img2 = (img1 + 0.1 * torch.rand(img1.shape, generator=gen, device=device)).clamp(0, 1)
    match = torch.zeros((b2, TRAIN_IMG, TRAIN_IMG, 1), device=device)
    c = slice(TRAIN_MARGIN, TRAIN_IMG - TRAIN_MARGIN)
    match[:, c, c] = torch.rand(match[:, c, c].shape, generator=gen, device=device)
    rows = slice(rank * b2 // world, (rank + 1) * b2 // world)
    l1, l2, lm = img1[rows].contiguous(), img2[rows].contiguous(), match[rows].contiguous()
    i_k, i_p = l1.clone().requires_grad_(), l1.clone().requires_grad_()
    loss_k = masked_ssim_loss(i_k, l2, lm, group)
    loss_p = masked_ssim_loss_ref(i_p, l2, lm, group)
    one = torch.ones((), device=device)
    d_k = torch.autograd.grad(loss_k, i_k, one, retain_graph=True)[0]
    d_p = torch.autograd.grad(loss_p, i_p, one, retain_graph=True)[0]
    rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    err = (d_k - d_p).abs().max().item()
    scale = d_p.abs().max().item()
    require(rel <= 1e-5, f"masked_ssim_global: relative err {rel} > 1e-5")
    require(err <= 1e-4 * scale, f"masked_ssim_bwd_global: max abs err {err} > 1e-4 * {scale}")
    whole = img1.clone().requires_grad_()
    loss_w = masked_ssim_loss(whole, img2, match)
    d_w = torch.autograd.grad(loss_w, whole, one)[0][rows]
    rel_w = abs(loss_k.item() - loss_w.item()) / abs(loss_w.item())
    err_w = (d_k / world - d_w).abs().max().item()
    require(rel_w <= 1e-5 and err_w <= 1e-4 * d_w.abs().max().item(),
            f"masked_ssim_global: against the whole batch: loss {rel_w}, gradient {err_w}")
    fwd_bytes = nbytes(l1, l2, lm, loss_k)
    fwd = {"max_abs_err_global": abs(loss_k.item() - loss_p.item()), "rel_err_global": rel,
           "rel_err_whole_global": rel_w,
           **paired_ms(lambda: masked_ssim_loss(i_k, l2, lm, group),
                       lambda: masked_ssim_loss_ref(i_p, l2, lm, group), suffix="_global"),
           **bound(fwd_bytes, 245 * l1.numel() + 44 * lm.numel(), "_global")}
    bwd = {"max_abs_err_global": err, "grad_scale_global": scale, "err_whole_global": err_w,
           **paired_ms(_grads(loss_k, i_k, one), _grads(loss_p, i_p, one), suffix="_global"),
           **bound(nbytes(l1, l2, lm, l1), 392 * l1.numel() + 44 * lm.numel(), "_global")}
    return fwd, bwd


def _grad_gaps(got, ref):
    """Phase (f)'s measures of two gradient sets: the median over tensors of
    each tensor's max error over its largest magnitude, the least cosine
    (and its tensor), the largest gap of a norm ratio from 1."""
    of_max = [((got[k] - v).abs().max() / v.abs().max()).item() for k, v in ref.items()]
    cosine = {k: torch.nn.functional.cosine_similarity(got[k].flatten(), v.flatten(),
                                                       dim=0).item() for k, v in ref.items()}
    worst = min(cosine, key=cosine.get)
    return {"grad_err_of_max_median": float(np.median(of_max)), "min_cosine": cosine[worst],
            "worst": worst, "max_norm_ratio_gap": max(abs(got[k].norm().item() / v.norm().item()
                                                          - 1) for k, v in ref.items())}


def _synced_formula(nets):
    """Every train-mode BatchNorm of `nets` normalizes through
    `_synced_forward` in this one process (no group: its all-reduce is the
    identity): the synced path's arithmetic without a second rank."""
    from ransacflow_tpu_torch.models.layers import BatchNorm2d

    def forward(x, m):
        if m.training:
            return m._synced_forward(x.to(m.weight.dtype))
        return BatchNorm2d.forward(m, x)

    for net in nets.values():
        for m in net.modules():
            if isinstance(m, BatchNorm2d):
                m.forward = functools.partial(forward, m=m)


def _dp_against_single(name, ranks, images, card):
    """The ranks' results against the single-process step on the whole
    batch on cuda:0: every rank's gradients equal, the losses to 1e-4
    relative, the statistics to 1e-4, and the gradients by phase (f)'s
    measures: each cosine >= 0.999, each norm within 1% (a world-size factor
    would be 100%), and the median max error over the largest magnitude at
    most 1.5 times the largest that the single step shows when its images
    are nudged by 3e-7 (three draws, in this run: the step's conditioning;
    the draws spread by about 10%). Any rounding-level change moves this
    step's gradients that far, and the synced BatchNorm's arithmetic is
    one: the single step with it (`_synced_formula`) moves as far, while
    the data-parallel and the single step each agree with themselves to
    ~1e-6. Those floors are returned beside the gaps."""
    from ransacflow_tpu_torch.train import train_grads

    n_pairs = len(images) // 2
    nudged = [images + np.float32(3e-7) * np.random.RandomState(s).randn(*images.shape)
              .astype(np.float32) for s in range(3)]
    singles = []
    for imgs, synced in [(images, False), (images, False), (images, True)] + [
            (x, False) for x in nudged]:
        nets, opt = _new_trainer("cuda", 3)
        if synced:
            _synced_formula(nets)
        metrics = train_grads(nets, opt, *_train_batch(torch.from_numpy(imgs).cuda(), n_pairs,
                                                       TRAIN_IMG, TRAIN_MARGIN),
                              **_stage_kwargs(3))
        singles.append(({k: float(v) for k, v in metrics.items()}, *_grad_state(nets)))
        del nets, opt
    (loss, grads, bn), (_, grads2, _), (_, grads_synced, _) = singles[:3]
    for r in ranks[1:]:
        require(all(torch.equal(r["grads"][k], v) for k, v in ranks[0]["grads"].items()),
                f"{name}: the ranks' reduced gradients differ")
    got = ranks[0]
    require(grads.keys() == got["grads"].keys(), f"{name}: gradient sets")
    rel = max(abs(got["metrics"][k] - v) / max(abs(v), 1e-7) for k, v in loss.items())
    bn_err = max((got["bn"][k] - v).abs().max().item() / max(v.abs().max().item(), 1.0)
                 for k, v in bn.items())
    gaps = _grad_gaps(got["grads"], grads)
    nudged = [_grad_gaps(g, grads) for _, g, _ in singles[3:]]
    limit = 1.5 * max(g["grad_err_of_max_median"] for g in nudged)
    require(rel <= 1e-4 and bn_err <= 1e-4 and gaps["grad_err_of_max_median"] <= limit
            and gaps["min_cosine"] >= 0.999 and gaps["max_norm_ratio_gap"] <= 1e-2,
            f"{name}: against one process on the whole batch: losses {rel}, statistics "
            f"{bn_err}, gradients {gaps} (median limit {limit})")
    floors = {"median_limit": limit, "nudged_vs_single": nudged,
              "single_vs_single": _grad_gaps(grads2, grads),
              "synced_formula_vs_single": _grad_gaps(grads_synced, grads)}
    if "grads2" in got:
        floors["dp_vs_dp"] = _grad_gaps(got["grads2"], got["grads"])
    return {"loss_rel_err": rel, "bn_stat_err": bn_err, **gaps, "n_grads": len(grads),
            **floors, "losses": got["metrics"]}


def _sum_launches(counts):
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def _sharded_serving(card, devices, n_pairs, reference_devices):
    """`sharded_align_pairs` of `n_pairs` of phase (d)'s pairs over `devices`
    against the same over `reference_devices` (the per-pair seeds from one
    generator seed: bit for bit), timed in turns; and, on one card,
    against `fused_align_batch` on the per-pair seeds (bit for bit)."""
    from ransacflow_tpu_torch.parallel import sharded_align_pairs
    from ransacflow_tpu_torch.parallel.mesh import draw_seeds, seeded_generators
    from ransacflow_tpu_torch.pipeline.fused import device_pyramid, fused_align_batch
    from ransacflow_tpu_torch.utils.image import pyramid_shapes

    shapes = pyramid_shapes()
    rng = np.random.RandomState(0)
    sources = torch.from_numpy(_blocky(rng, n_pairs, *shapes[0])).cuda()
    targets = torch.from_numpy(_blocky(rng, n_pairs, *TARGET_HW)).cuda()[:, None]
    pyramids = tuple(p[:, None] for p in device_pyramid(sources, shapes))
    resnet, align = _nets("cuda")
    gen = lambda: torch.Generator(device="cuda").manual_seed(2)  # noqa: E731

    def serve(devs):
        return sharded_align_pairs(devs, resnet, align, pyramids, targets, gen(), n_iter=N_ITER)

    out, launches = _launches_of(lambda: serve(devices))
    ref = serve(reference_devices)
    for key, v in ref.items():
        require(torch.equal(out[key], v), f"sharded serving over {devices}: {key} differs from "
                                          f"{reference_devices}")
    if len(set(map(str, devices))) == 1:
        seeds = draw_seeds(gen(), n_pairs)
        plain = fused_align_batch(resnet, align, pyramids, targets,
                                  seeded_generators(seeds, "cuda"), n_iter=N_ITER)
        for key, v in plain.items():
            require(torch.equal(out[key], v), f"sharded serving: {key} differs from "
                                              "fused_align_batch on the per-pair seeds")
    _require_launched(f"sharded serving over {devices}", launches,
                      [k for k in SERVING_KERNELS if k != "lanczos_pyramid"],
                      {"compose_tail": n_pairs, **_per_fine_pass(launches)})
    ms = {}
    for devs, tag in ((reference_devices, "reference"), (devices, "sharded"),
                      (devices, "sharded"), (reference_devices, "reference")):
        ms.setdefault(tag, []).append(_best_ms(lambda: serve(devs), reps=2))
    pairs_s = {tag: n_pairs / (min(v) / 1e3) for tag, v in ms.items()}
    print(f"(m) sharded serving of {n_pairs} pairs (480x640, 7 scales, {N_ITER} hypotheses) "
          f"over {[str(d) for d in devices]}: bit for bit the run over "
          f"{[str(d) for d in reference_devices]}; pairs/s {pairs_s}; launches {launches} "
          f"on {card}", flush=True)
    return launches, {"pairs_s": pairs_s, "n_pairs": n_pairs,
                      "devices": [str(d) for d in devices]}


def _sharded_ransac_check(card, devices):
    """`sharded_ransac` over `devices` on phase (c)'s serving matches
    (10k hypotheses) against each shard's own K3 fit on its seed: the
    winner (the first of the largest counts) bit for bit."""
    from ransacflow_tpu_torch.ops.ransac import ransac_homography
    from ransacflow_tpu_torch.parallel import sharded_ransac
    from ransacflow_tpu_torch.parallel.mesh import draw_seeds, seeded_generators

    m1, m2, valid = _ransac_matches(torch.Generator(device="cuda").manual_seed(13))
    gen = lambda: torch.Generator(device="cuda").manual_seed(14)  # noqa: E731
    res, launches = _launches_of(lambda: sharded_ransac(devices, m1, m2, valid, 0.05,
                                                        n_iter=N_ITER, generator=gen()))
    per = -(-N_ITER // len(devices))
    shards = [ransac_homography(m1.to(d), m2.to(d), valid.to(d), 0.05, n_iter=per,
                                generator=g)
              for d, g in zip(devices, [seeded_generators([s], d)[0] for s, d in
                                        zip(draw_seeds(gen(), len(devices)), devices)])]
    counts = [int(s.num_inliers) for s in shards]
    best = shards[int(np.argmax(counts))]
    for a, b in zip(res, best):
        require(torch.equal(a, b.to(a.device)), "sharded_ransac: the winner differs from the "
                                                "shards' own fits")
    require(launches["ransac_score"] == len(devices), f"sharded_ransac: launches {launches}")
    print(f"(m) sharded_ransac over {[str(d) for d in devices]}: counts {counts}, winner "
          f"{int(res.num_inliers)}, launches {launches['ransac_score']} K3 on {card}",
          flush=True)
    return launches, {"counts": counts}


def _dp_one_card(card, results):
    """The one-card proof: two ranks on cuda:0 over gloo (NCCL refuses two
    ranks on one device); each rank first holds gloo's all-reduce of a CUDA
    tensor to the world size."""
    from ransacflow_tpu_torch.parallel import spawn

    images = _dp_images(TRAIN_PAIRS, 31)
    ranks = spawn(_dp_rank, SHARD_SLOTS, "gloo", args=(images, 0, True), timeout=300)
    form = "gloo, 2 ranks on cuda:0"
    launches = _sum_launches([r["launches"] for r in ranks])
    _require_launched("dp_train", launches, DP_KERNELS)
    check = _dp_against_single("dp_train", ranks, images, card)
    fwd, bwd = ranks[0]["ssim"]
    results["masked_ssim"].update(fwd)
    results["masked_ssim_bwd"].update(bwd)
    print(f"(m) data-parallel stage-3 step ({form}, {TRAIN_PAIRS} global pairs of "
          f"{TRAIN_IMG}x{TRAIN_IMG}) against one process on the whole batch: {check}; "
          f"launches {launches}; K10 global form: "
          f"{ {k: v for k, v in results['masked_ssim'].items() if k.endswith('_global')} } "
          f"on {card}", flush=True)
    return form, launches, check


def _dp_four_cards(card):
    """NCCL, one rank a card: the stage-3 step at 16 pairs a card (weak) and
    16 global pairs (strong) against one process on cuda:0 at 16 pairs, in
    the same call; the 16-global run also held to that process's step."""
    from ransacflow_tpu_torch.parallel import make_mesh, spawn
    from ransacflow_tpu_torch.train import train_step

    devices = make_mesh(MC_CARDS)
    images16 = _dp_images(TRAIN_PAIRS, 31)
    nets, opt = _new_trainer("cuda", 3)
    batch = _train_batch(torch.from_numpy(images16).cuda(), TRAIN_PAIRS, TRAIN_IMG,
                         TRAIN_MARGIN)
    one_ms, one_all, one_gb = _timed_steps(
        lambda: train_step(nets, opt, *batch, **_stage_kwargs(3)), MC_TIMED_STEPS)
    del nets, opt, batch
    strong = spawn(_dp_rank, devices, "nccl", args=(images16, MC_TIMED_STEPS, False),
                   timeout=600)
    check = _dp_against_single("dp_train_4_cards", strong, images16, card)
    weak = spawn(_dp_rank, devices, "nccl",
                 args=(_dp_images(TRAIN_PAIRS * MC_CARDS, 32), MC_TIMED_STEPS, False),
                 timeout=600)

    def read(rs, n_pairs):
        return {"step_ms": rs[0]["step_ms"], "pairs_s": n_pairs / (rs[0]["step_ms"] / 1e3),
                "peak_gb": [r["peak_gb"] for r in rs], "profile": rs[0]["profile"],
                "step_ms_all": rs[0]["step_ms_all"]}

    out = {"one_card": {"step_ms": one_ms, "pairs_s": TRAIN_PAIRS / (one_ms / 1e3),
                        "peak_gb": one_gb, "step_ms_all": one_all},
           "strong_16_global": read(strong, TRAIN_PAIRS),
           "weak_16_a_card": read(weak, TRAIN_PAIRS * MC_CARDS), "check": check}
    out["weak_efficiency"] = one_ms / out["weak_16_a_card"]["step_ms"]
    out["strong_efficiency"] = one_ms / (MC_CARDS * out["strong_16_global"]["step_ms"])
    launches = _sum_launches([r["launches"] for r in strong])
    _require_launched("dp_train_4_cards", launches, DP_KERNELS)
    print(f"(m) NCCL data parallelism on {MC_CARDS} cards: {out} on {card}", flush=True)
    return launches, out


def _cli_four_cards(tmp):
    """`cli.train --distributed` under torchrun and `cli.train --nDevices 4`
    (spawned), 2 full-width steps each, each checkpoint loaded back."""
    from PIL import Image

    from ransacflow_tpu_torch.train import load_checkpoint

    data = f"{tmp}/data"
    os.makedirs(data)
    rng = np.random.RandomState(5)
    for idx in range(2 * TRAIN_PAIRS):  # 2 steps of the global batch
        base = (_blocky(rng, 1, 256, 320)[0] * 255).astype(np.uint8)
        for view, shift in ((1, 0), (2, 6)):
            Image.fromarray(np.roll(base, shift, axis=1)).save(f"{data}/{idx}_{view}.jpg")
    args = ["--trainImgDir", data, "--stage", "3", "--batchSize", str(TRAIN_PAIRS),
            "--imgSize", str(TRAIN_IMG), "--margin", str(TRAIN_MARGIN), "--nEpochs", "1",
            "--maxStepsPerEpoch", "2", "--device", "cuda", "--nDevices", str(MC_CARDS)]
    runs = {"torchrun": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                         "--nproc_per_node", str(MC_CARDS), "-m",
                         "ransacflow_tpu_torch.cli.train", "--distributed"],
            "spawned": [sys.executable, "-m", "ransacflow_tpu_torch.cli.train"]}
    out = {}
    for name, cmd in runs.items():
        t0 = time.perf_counter()
        proc = subprocess.run([*cmd, *args, "--outDir", f"{tmp}/{name}", "NoVal",
                               "--epochSaveModel", "1"], capture_output=True, text=True,
                              timeout=600)
        seconds = time.perf_counter() - t0
        require(proc.returncode == 0, f"cli.train {name}: exited {proc.returncode}:\n"
                                      f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        recs = [json.loads(line) for line in open(f"{tmp}/{name}/metrics.jsonl")]
        nets, opt = _new_trainer("cuda", 3)
        ckpt = load_checkpoint(f"{tmp}/{name}/checkpoint_epoch0.pt", nets, opt)
        require(ckpt["step"] == 0 and recs[-1]["step"] == 0 and np.isfinite(recs[-1]["loss"]),
                f"cli.train {name}: {recs[-1]}")
        out[name] = {"seconds": seconds, "epoch_record": recs[-1]}
    return out


def _pool_four_cards(card, root, resnet, align):
    """HPatches and YFCC predict with `--nDevices 4` (n_devices=4) against
    the 1-slot pass, and KITTI's pool of 4 cards against its sequential
    pass: artifacts bit for bit, else within POOL_TOL; pairs/s."""
    from ransacflow_tpu_torch.eval import hpatches, kitti, yfcc

    hp = f"{root}/hpatches"
    pkl, scene, _ = _yfcc_dataset(root)
    launches, readings = {}, {}
    harnesses = {
        "hpatches": (lambda out, kw: hpatches.predict_hpatches(
            hp, hp, out, resnet, align, "cuda", scenes=(2,), **kw), "2"),
        "yfcc": (lambda out, kw: yfcc.predict_yfcc(pkl, scene, out, resnet, align, "cuda",
                                                   **kw), ""),
    }
    for harness, (predict, sub) in harnesses.items():
        seconds = {}
        for route, n in (("one_slot", 1), ("four_cards", MC_CARDS)):
            out = f"{root}/{harness}_{route}"
            (_, got), seconds[route] = _timed(lambda: _launches_of(
                lambda: predict(out, dict(n_devices=n))))
            launches[f"{harness}_{route}"] = got
        gap = _artifact_gap(f"{harness} four cards", f"{root}/{harness}_one_slot/{sub}",
                            f"{root}/{harness}_four_cards/{sub}")
        readings[harness] = {"max_abs_diff": gap,
                             "pairs_s": {r: EVAL_PAIRS / t for r, t in seconds.items()}}
    kt = f"{root}/kitti/image_2"
    (_, _), seq_s = _timed(lambda: _launches_of(lambda: kitti.predict_kitti(
        kt, f"{root}/kitti_seq", resnet, align, "cuda", end_index=EVAL_PAIRS)))
    (_, pool), pool_s = _timed(lambda: _launches_of(lambda: kitti.pooled_kitti_predict(
        kt, f"{root}/kitti_pool4", resnet, align, [f"cuda:{i}" for i in range(MC_CARDS)],
        end_index=EVAL_PAIRS)))
    readings["kitti"] = {"max_abs_diff": _artifact_gap("kitti four cards", f"{root}/kitti_seq",
                                                       f"{root}/kitti_pool4"),
                         "pairs_s": {"sequential": EVAL_PAIRS / seq_s,
                                     "four_cards": EVAL_PAIRS / pool_s}}
    launches["kitti_four_cards"] = pool
    print(f"(m) the eval pool on {MC_CARDS} cards against one slot ({EVAL_PAIRS} pairs each): "
          f"{readings} on {card}", flush=True)
    return launches, readings


def phase_multicard(card, results):
    """(m) Data parallelism: on one card, the data-parallel step over two
    ranks on cuda:0 (with K10's global form), sharded serving and sharded
    RANSAC over two slots of cuda:0; on four or more cards also NCCL over
    four, the two CLI launches, sharded serving at bench.py's batch, the
    eval pool and sharded RANSAC over four cards."""
    import tempfile

    t0 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    form, dp_launches, dp_check = _dp_one_card(card, results)
    paths = {"dp_train": dp_launches}
    paths["sharded_serving"], serving = _sharded_serving(card, SHARD_SLOTS, N_PAIRS, ["cuda:0"])
    paths["sharded_ransac"], ransac = _sharded_ransac_check(card, SHARD_SLOTS)
    readings = {"one_card": {"dp_form": form, "dp_check": dp_check, "serving": serving,
                             "ransac": ransac}}
    forms = [f"dp_train ({form})", "sharded_serving (2 slots on cuda:0)",
             "sharded_ransac (2 slots on cuda:0)"]
    if n_cards >= MC_CARDS:
        from ransacflow_tpu_torch.models.convert import (
            alignment_params_from_tree, init_resnet50_layer3, load_params_npz)
        from ransacflow_tpu_torch.parallel import make_mesh

        cards = make_mesh(MC_CARDS)
        paths["dp_train_4_cards"], readings["dp_4_cards"] = _dp_four_cards(card)
        with tempfile.TemporaryDirectory() as tmp:
            readings["cli_4_cards"] = _cli_four_cards(tmp)
        print(f"(m) cli.train on {MC_CARDS} cards: {readings['cli_4_cards']} on {card}",
              flush=True)
        paths["sharded_serving_4_cards"], readings["serving_4_cards"] = _sharded_serving(
            card, cards, MC_SERVE_PAIRS, ["cuda:0"])
        resnet = init_resnet50_layer3(torch.Generator().manual_seed(0), "cuda")
        align = alignment_params_from_tree(load_params_npz(ACCEPT_WEIGHTS), "cuda")
        with tempfile.TemporaryDirectory() as root:
            _eval_datasets(root)
            got, readings["pool_4_cards"] = _pool_four_cards(card, root, resnet, align)
        paths.update(got)
        paths["sharded_ransac_4_cards"], readings["ransac_4_cards"] = _sharded_ransac_check(
            card, cards)
        forms += [f"NCCL on {MC_CARDS} cards", "cli.train torchrun and spawned",
                  f"sharded serving over {MC_CARDS} cards", f"eval pool of {MC_CARDS} cards",
                  f"sharded_ransac over {MC_CARDS} cards"]
    readings["seconds"] = time.perf_counter() - t0
    print(f"(m) ran {forms} with {n_cards} cards in {readings['seconds']:.1f} s on {card}",
          flush=True)
    return paths, readings


# -- (n) the batch modes of the serving loop -----------------------------------
BATCH_MODES = ("scan", "vmap", "hybrid", "chunk2", "chunkf2", "chunkv2")
# bench.py's fast-mode series (chunk2 at anchor stride 3, relax 1) and vmap
# with adaptive RANSAC, each held to scan in its configuration: (options,
# modes)
BATCH_EXTRAS = {"anchor": (ANCHOR, ("scan", "chunk2")),
                "adaptive": ({"adaptive_chunk": MH_CHUNK}, ("scan", "vmap"))}


def _mode_launches(mode, adaptive_chunk=0, anchor_stride=0, **_):
    """The launches of one call at N_PAIRS pairs in a batch mode: a chunk
    launches K2 once, K3 (or K4) once, K12 once in the anchor mode, and runs
    one fine pass (one compose_tail launch)."""
    from ransacflow_tpu_torch.pipeline.fused import parse_batch_mode

    n = N_PAIRS // parse_batch_mode(mode, N_PAIRS)
    return {"mutual_argmax": n, "ransac_score": 0 if adaptive_chunk else n,
            "ransac_adaptive": n if adaptive_chunk else 0,
            "anchor_resample": n if anchor_stride else 0, "compose_tail": n}


# a differing coarse match must be a near tie in scan's own score: the gap
# between the two best scores of its column, or of its source's row (fp32:
# trunk maps that differ in their last bits; bf16: maps whose every layer
# rounds to bf16 what another cuDNN algorithm for the batch summed)
TIE_GAP = {"fp32": 1e-4, "bf16": 1e-2}


def _mode_matches(resnet, pyramids, targets, mode, anchor_stride=0, relax_cells=0, **_):
    """(m1, m2 (K, nB, 3), valid (K, nB)) of a batch mode's coarse step:
    `_coarse_match_batch` over the mode's chunks (of one pair for scan)."""
    from ransacflow_tpu_torch.pipeline.fused import _coarse_match_batch, parse_batch_mode

    kw = dict(anchor_stride=anchor_stride, relax_cells=relax_cells)
    c = parse_batch_mode(mode, targets.shape[0])
    with torch.inference_mode():
        got = [_coarse_match_batch(resnet, tuple(p[c0:c0 + c, 0] for p in pyramids),
                                   targets[c0:c0 + c, 0], **kw)
               for c0 in range(0, targets.shape[0], c)]
    return tuple(torch.cat([g[i] for g in got]) for i in range(3))


def _tie_gaps(resnet, pyramid, target, cells, anchor_stride=0, relax_cells=0, **_):
    """For target cells `cells` of one pair, scan's score margins: the
    smaller of the gap between the two best scores of the cell's column and
    that of its best source's row."""
    from ransacflow_tpu_torch.ops.matching import score_gemm
    from ransacflow_tpu_torch.pipeline.bank import anchor_bank, coarse_features

    with torch.inference_mode():
        bank = (anchor_bank(resnet, pyramid, anchor_stride)[0] if anchor_stride else
                torch.cat([coarse_features(resnet, im).flatten(0, 2) for im in pyramid]))
        featt = coarse_features(resnet, target).flatten(0, 2)
        score = score_gemm(bank.T, featt.T).float()
    col = score[:, cells].topk(2, dim=0).values
    row = score[score[:, cells].argmax(dim=0)].topk(2, dim=1).values
    return torch.minimum(col[0] - col[1], row[:, 0] - row[:, 1]).tolist()


def _agreement(key, name, resnet, pyramids, targets, out, ref, matches, ref_matches, kw):
    """A mode's run against scan's (Tentpole section 6): the coarse matches
    first, each differing cell a near tie of scan's score (its margin
    printed and the cells counted); then, on the pairs whose matches are
    equal, H21 within 1e-5, num_inliers equal but for matches on the
    tolerance boundary (`boundary_flips`' window, 1e-5), and in fp32 the flow
    within 1e-3."""
    from ransacflow_tpu_torch.ops.homography import reprojection_error

    from ransacflow_tpu_torch.pipeline.bank import coarse_features

    (m1, _, valid), (m1_s, m2_s, valid_s) = matches, ref_matches
    n_b = valid.shape[1]
    rep = {"cells_differ": 0, "tie_gaps": [], "pairs_equal": 0, "h21_max_err": 0.0,
           "inlier_flips": 0, "flow_max_err": 0.0}
    for k in range(targets.shape[0]):
        differ = (valid[k] != valid_s[k]) | (valid[k] & (m1[k] != m1_s[k]).any(dim=-1))
        cells = differ.nonzero()[:, 0]
        if cells.numel() and "target_feature_max_err" not in rep:
            with torch.inference_mode():  # the trunk alone, one target and the batch
                one = coarse_features(resnet, targets[k]).float()
                batch = coarse_features(resnet, targets[:, 0])[k:k + 1].float()
            rep["target_feature_max_err"] = (one - batch).abs().max().item()
        if cells.numel():
            gaps = _tie_gaps(resnet, tuple(p[k] for p in pyramids), targets[k], cells, **kw)
            rep["cells_differ"] += cells.numel()
            rep["tie_gaps"] += gaps
            require(max(gaps) <= TIE_GAP[key],
                    f"{name}: pair {k}: {cells.numel()} coarse matches differ from scan's, "
                    f"margins {gaps} > {TIE_GAP[key]}")
            continue
        rep["pairs_equal"] += 1
        err = (out["H21"][k] - ref["H21"][k]).abs().max().item()
        rep["h21_max_err"] = max(rep["h21_max_err"], err)
        require(err <= 1e-5 and bool(out["found"][k] == ref["found"][k]),
                f"{name}: pair {k}: H21 {err} from scan's on equal matches")
        d_inl = abs(int(out["num_inliers"][k]) - int(ref["num_inliers"][k]))
        if d_inl:
            res = reprojection_error(m1_s[k], m2_s[k], ref["H21"][k][None])[0]
            near = int((((res - 0.05).abs() <= 1e-5) & valid_s[k]).sum())
            require(d_inl <= near, f"{name}: pair {k}: inliers {int(out['num_inliers'][k])} "
                                   f"vs scan's {int(ref['num_inliers'][k])}, {near} matches "
                                   "on the tolerance boundary")
            rep["inlier_flips"] += d_inl
        ferr = (out["flow"][k].float() - ref["flow"][k].float()).abs().max().item()
        rep["flow_max_err"] = max(rep["flow_max_err"], ferr)
        if key == "fp32":
            require(ferr <= 1e-3, f"{name}: pair {k}: flow {ferr} from scan's")
    # fp32: a few near ties at most; bf16: as many as the roundings flip
    require(key != "fp32" or rep["cells_differ"] <= 0.01 * targets.shape[0] * n_b,
            f"{name}: {rep['cells_differ']} coarse matches differ from scan's")
    if rep["tie_gaps"]:
        rep["tie_gaps"] = [min(rep["tie_gaps"]), max(rep["tie_gaps"])]
    return rep


def phase_batch_modes(card):
    """(n) `fused_align_batch` in each batch mode on phase (d)'s 4 full-width
    pairs (480x640 targets, 7 scales from 960x1280, 10k hypotheses, cycle
    match, seeded weights), fp32 (TF32 off) and bf16 (the eval policy);
    then chunk2 at anchor stride 3 with relax_cells 1 (bench.py's fast-mode
    series) and vmap with adaptive RANSAC (blocks of 4096), each beside
    scan in its configuration. Per run: agreement with scan (`_agreement`)
    and with the first mode of the same chunk size, the launches of K2,
    K3, K4 and K12 and the fine passes in one call (`_mode_launches`: one
    each a chunk), pairs/s
    (CUDA events, best of 3 after the checked call), peak memory and the
    card's idle share of one traced call."""
    from ransacflow_tpu_torch.cli.common import cast_for_dtype
    from ransacflow_tpu_torch.pipeline.fused import (
        device_pyramid, fused_align_batch, parse_batch_mode)
    from ransacflow_tpu_torch.utils.image import pyramid_shapes

    t0 = time.perf_counter()
    shapes = pyramid_shapes()
    rng = np.random.RandomState(0)
    sources = torch.from_numpy(_blocky(rng, N_PAIRS, *shapes[0])).cuda()
    targets = torch.from_numpy(_blocky(rng, N_PAIRS, *TARGET_HW)).cuda()[:, None]
    resnet, align = _nets("cuda")
    nets = {"fp32": (resnet, align),
            "bf16": (cast_for_dtype(resnet, "bfloat16"), cast_for_dtype(align, "bfloat16"))}
    pyramids = tuple(p[:, None] for p in device_pyramid(sources, shapes))
    # (name, mode, options, launches, timed): the extras' scan runs are
    # references only
    runs = [(mode, mode, {}, _mode_launches(mode), True) for mode in BATCH_MODES]
    for extra, (kw, modes) in BATCH_EXTRAS.items():
        runs += [(f"{mode}_{extra}", mode, kw, _mode_launches(mode, **kw), mode != "scan")
                 for mode in modes]
    paths, readings = {}, {}
    for key in nets:
        r, a = nets[key]

        def serve(mode, kw):
            pyr = tuple(p[:, None] for p in device_pyramid(sources, shapes))
            return fused_align_batch(r, a, pyr, targets,
                                     torch.Generator(device="cuda").manual_seed(2),
                                     n_iter=N_ITER, batch_mode=mode, **kw)

        refs, siblings = {}, {}
        for name, mode, kw, want, timed in runs:
            path = f"batch_{name}_{key}"
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out, launches = _launches_of(lambda: serve(mode, kw))
            peak = torch.cuda.max_memory_allocated()
            _require_launched(path, launches, SERVING_KERNELS if "adaptive" not in name else
                              [k for k in SERVING_KERNELS if k != "ransac_score"], want)
            for field in ("H21", "flow", "match", "flow_down8", "match_down8"):
                require(bool(torch.isfinite(out[field]).all()), f"{path}: {field} not finite")
            matches = _mode_matches(r, pyramids, targets, mode, **kw)
            reading = {"found": out["found"].tolist(), "inliers": out["num_inliers"].tolist()}
            if mode == "scan":
                refs[name.replace("scan", "", 1)] = (out, matches)
            else:
                ref, ref_matches = refs[name[len(mode):]]
                reading["agreement"] = _agreement(key, path, r, pyramids, targets, out, ref,
                                                  matches, ref_matches, kw)
                # a mode of another's chunk size (vmap and hybrid; chunk2,
                # chunkf2 and chunkv2) runs its path: held to that mode's run,
                # which checks RANSAC and the fine stage where bf16's roundings
                # leave no pair equal to scan's
                group = (name[len(mode):], parse_batch_mode(mode, N_PAIRS))
                if group in siblings:
                    sib, sib_out, sib_matches = siblings[group]
                    reading["agreement_with_" + sib] = _agreement(
                        key, path, r, pyramids, targets, out, sib_out, matches, sib_matches, kw)
                    require(reading["agreement_with_" + sib]["pairs_equal"] == N_PAIRS,
                            f"{path}: coarse matches differ from {sib}'s")
                else:
                    siblings[group] = (mode, out, matches)
            reading["launches"] = {k: launches[k] for k in want}
            reading.update(peak_gb=peak / 1e9, peak_over_resident_gb=(peak - base) / 1e9)
            paths[path], readings[path] = launches, reading
            if not timed:
                print(f"(n) {path}: {reading} on {card}", flush=True)
                continue
            best = _best_ms(lambda: serve(mode, kw))
            prof = _profile_step(lambda: serve(mode, kw), reps=1)
            reading.update({
                "pairs_s": N_PAIRS / (best / 1e3), "best_ms": best,
                "device_ms": prof["device_ms"],
                "idle_share": max(0.0, 1.0 - prof["device_ms"] / best)})
            print(f"(n) {path}: {reading} on {card}", flush=True)
    readings["seconds"] = time.perf_counter() - t0
    print(f"(n) batch modes ({N_PAIRS} pairs at 480x640, 7 scales, {N_ITER} hypotheses, fp32 "
          f"and bf16) in {readings['seconds']:.1f} s on {card}", flush=True)
    return paths, readings


# -- (o) the JAX surface outside the main paths --------------------------------

SURFACE_HEADS = (1, 60, 80, 49)  # a fine pass's correlation volume at 480x640
SURFACE_TOL = 1e-5  # the kernels against their plain twins on the card (K7's rows)
SURFACE_CPU_TOL = 1e-4  # the card's values against the CPU's
# the card's gradient to the correlation against the CPU's, relative L2: a
# ReLU whose input lies within the two devices' rounding of 0 passes the
# gradient on one and not on the other
SURFACE_CPU_GRAD_TOL = 1e-2
DEMO_KERNELS = ("mutual_argmax", "ransac_score", "warp_homography", "correlation_pair",
                "head_epilogues", "compose_tail", "blur_pool", "warp_sample")


def _max_err(a, b):
    return (a.detach().cpu() - b.detach().cpu()).abs().max().item()


def _pred_heads_against_plain(align, gen):
    """`pred_flow_coarse` (gradient magnitude and grid) and
    `pred_matchability` under grad at a fine pass's (1, 60, 80, 49), with
    the gradient of all three outputs to the correlation: on the card
    through K7 and its backward, against the same networks with K7's plain
    twins on the card (values and gradient within SURFACE_TOL of the larger
    of 1 and the plain one's largest magnitude: the same cuDNN calls) and
    on the CPU (values within SURFACE_CPU_TOL; the gradient by relative L2
    error and cosine). Returns (errors, launches of the kernels' run)."""
    import copy

    from ransacflow_tpu_torch.kernels import heads as k7
    from ransacflow_tpu_torch.models import heads

    corr = torch.rand(SURFACE_HEADS, generator=gen, device="cuda")
    grid = 2.2 * torch.rand((1, 480, 640, 2), generator=gen, device="cuda") - 1.1
    cots = [torch.randn(shape, generator=gen, device="cuda")
            for shape in ((1, 479, 639, 1), (1, 480, 640, 2), (1, 480, 640, 1))]
    nets = {"cuda": (align["netFlowCoarse"], align["netMatch"]),
            "cpu": (copy.deepcopy(align["netFlowCoarse"]).cpu(),
                    copy.deepcopy(align["netMatch"]).cpu())}

    def run(device):
        flow_net, match_net = nets[device]
        c = corr.to(device).requires_grad_()
        mag, out_grid = heads.pred_flow_coarse(flow_net, c, grid.to(device))
        outs = (mag, out_grid, heads.pred_matchability(match_net, c))
        (d,) = torch.autograd.grad(outs, [c], [g.to(device) for g in cots])
        return outs + (d,)

    got, launches = _launches_of(lambda: run("cuda"))
    _require_launched("surface_pred_heads", launches,
                      exact={"head_epilogues": 2, "head_epilogues_bwd": 2})
    kernels = heads.flow_epilogue, heads.match_epilogue
    heads.flow_epilogue, heads.match_epilogue = k7.flow_epilogue_ref, k7.match_epilogue_ref
    try:
        plain = run("cuda")
    finally:
        heads.flow_epilogue, heads.match_epilogue = kernels
    cpu = run("cpu")
    names = ("flow_gradient_magnitude", "grid", "matchability", "d_corr")
    errs = {}
    for name, a, b, c in zip(names, got, plain, cpu):
        require(tuple(a.shape) == tuple(b.shape) == tuple(c.shape),
                f"pred heads {name}: shapes {a.shape}, {b.shape}, {c.shape}")
        scale = max(1.0, b.abs().max().item())
        errs[name] = _max_err(a, b)
        require(errs[name] <= SURFACE_TOL * scale,
                f"pred heads {name}: kernel vs plain max abs err {errs[name]} > "
                f"{SURFACE_TOL} * {scale}")
        errs[name + "_cpu"] = _max_err(a, c)
        if name != "d_corr":
            scale = max(1.0, c.abs().max().item())
            require(errs[name + "_cpu"] <= SURFACE_CPU_TOL * scale,
                    f"pred heads {name}: card vs CPU max abs err {errs[name + '_cpu']} > "
                    f"{SURFACE_CPU_TOL} * {scale}")
    a, c = got[3].detach().cpu().flatten(), cpu[3].detach().flatten()
    errs["d_corr_cpu_rel_l2"] = ((a - c).norm() / c.norm()).item()
    errs["d_corr_cpu_cosine"] = torch.nn.functional.cosine_similarity(a, c, dim=0).item()
    require(errs["d_corr_cpu_rel_l2"] <= SURFACE_CPU_GRAD_TOL,
            f"pred heads d_corr: card vs CPU relative L2 error {errs['d_corr_cpu_rel_l2']} > "
            f"{SURFACE_CPU_GRAD_TOL}")
    return errs, launches


def _surface_ops_against_cpu(gen):
    """`saliency_coef`, `fit_hough`, `fit_translation` and `blur_pool_1d` on
    CUDA tensors against the CPU: saliency at the coarse stage's 30x40 cells
    of C = 1024 (L2-normalized), the fits over 4 sets of 1,200 matches,
    blur-pool over (2, 4096, 64). Plain torch on both (JAX uses no
    hand-shaped op for them); fit_translation equal."""
    from ransacflow_tpu_torch.models.layers import l2_normalize
    from ransacflow_tpu_torch.ops.blurpool import blur_pool_1d
    from ransacflow_tpu_torch.ops.homography import fit_hough, fit_translation
    from ransacflow_tpu_torch.ops.saliency import saliency_coef

    feat = l2_normalize(torch.randn((1, 30, 40, 1024), generator=gen, device="cuda"))
    y = torch.cat([2 * torch.rand((4, 1200, 2), generator=gen, device="cuda") - 1,
                   torch.ones((4, 1200, 1), device="cuda")], dim=-1)
    x = y * torch.tensor([1.1, 0.9, 1.0], device="cuda") + torch.tensor(
        [0.05, -0.03, 0.0], device="cuda")
    x[..., :2] += 0.01 * torch.randn((4, 1200, 2), generator=gen, device="cuda")
    sig = torch.randn((2, 4096, 64), generator=gen, device="cuda")
    cases = {"saliency_coef": (saliency_coef, (feat,), 1e-5),
             "fit_hough": (fit_hough, (x, y), 1e-4),
             "fit_translation": (fit_translation, (x, y), 0.0),
             "blur_pool_1d": (blur_pool_1d, (sig,), 1e-5)}
    errs = {}
    for name, (fn, args, tol) in cases.items():
        a, b = fn(*args), fn(*(t.cpu() for t in args))
        require(a.is_cuda and tuple(a.shape) == tuple(b.shape), f"{name}: {a.device} {a.shape}")
        errs[name] = _max_err(a, b)
        require(errs[name] <= tol, f"{name}: card vs CPU max abs err {errs[name]} > {tol}")
    return errs


def _demo_on_card(tmp):
    """`python -m ransacflow_tpu_torch.examples.synthetic_demo --device
    cuda` through its `main`, twice: the planted translation recovered
    within 0.02 normalized (tests/test_pipeline.py's bound), three PNGs,
    and the launches of the first call."""
    from ransacflow_tpu_torch.examples import synthetic_demo

    argv = ["--device", "cuda", "--outdir", f"{tmp}/demo"]
    t0 = time.perf_counter()
    (h_est, err_px), launches = _launches_of(lambda: synthetic_demo.main(argv))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    synthetic_demo.main(argv)
    second_s = time.perf_counter() - t0
    size = 256  # the demo's default --size
    require(h_est is not None, "demo: no homography found")
    require(err_px * 2 / (size - 1) < 0.02, f"demo: mean grid error {err_px} px")
    require(all(os.path.exists(f"{tmp}/demo/{n}")
                for n in ("before.png", "after_coarse.png", "after_fine.png")),
            f"demo: blends missing: {os.listdir(f'{tmp}/demo')}")
    # the target's synthesis (warp_grid + K5's grid form) and align_images'
    # warped_fine are the two grid-form warps
    _require_launched("surface_demo", launches, DEMO_KERNELS,
                      {"anchor_resample": 0, "ransac_adaptive": 0, "lanczos_pyramid": 0,
                       "compose_tail": 1, **_per_fine_pass(launches, grid_form=2)})
    return {"err_px": err_px, "first_call_s": first_s, "second_call_s": second_s,
            "H21": h_est.tolist()}, launches


def _traced_serving(tmp, resnet, align):
    """One serving call (`fused_align_batch`, one full-width pair) inside
    `utils.monitor.profile_trace`: the trace file under its directory must
    name a hand kernel. A spin kernel goes first and a trace without a hand
    kernel is taken again (the profiler can miss launches, ROADMAP's watch
    list). Returns (reading, launches of the first traced call)."""
    from ransacflow_tpu_torch.pipeline.fused import device_pyramid, fused_align_batch
    from ransacflow_tpu_torch.utils.image import pyramid_shapes
    from ransacflow_tpu_torch.utils.monitor import profile_trace

    shapes = pyramid_shapes()
    rng = np.random.RandomState(0)
    source = torch.from_numpy(_blocky(rng, 1, *shapes[0])).cuda()
    target = torch.from_numpy(_blocky(rng, 1, *TARGET_HW)).cuda()[:, None]

    def serve():
        pyramids = tuple(p[:, None] for p in device_pyramid(source, shapes))
        out = fused_align_batch(resnet, align, pyramids, target,
                                torch.Generator(device="cuda").manual_seed(2), n_iter=N_ITER)
        torch.cuda.synchronize()
        return out

    serve()  # warm: the trace holds one steady call
    launches = None
    for attempt in range(3):
        log_dir = f"{tmp}/trace{attempt}"
        with profile_trace(log_dir):
            torch.cuda._sleep(100000)
            _, counts = _launches_of(serve)
        launches = launches or counts
        files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
        require(len(files) == 1, f"profile_trace wrote {files}")
        with open(f"{log_dir}/{files[0]}") as f:
            events = json.load(f)["traceEvents"]
        kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
        hand = sorted(k[:60] for k in kernels if _family(k) == "hand kernels")
        if hand:
            break
    require(hand, f"profile_trace: no hand kernel among {len(kernels)} traced kernels")
    _require_launched("surface_traced_serving", launches, SERVING_KERNELS)
    return {"trace_file": files[0], "trace_mb": os.path.getsize(f"{log_dir}/{files[0]}") / 1e6,
            "traced_kernels": len(kernels), "hand_kernels_traced": hand,
            "attempts": attempt + 1}, launches


def phase_surface(card):
    """(o) The JAX surface outside the main paths, on the card: the
    reference-API heads under grad against the CPU (K7 and its backward),
    the surface ops on CUDA tensors against the CPU, the synthetic demo on
    the card, and one serving call inside `profile_trace`. Its paths are
    `surface_pred_heads`, `surface_demo` and `surface_traced_serving`."""
    import tempfile

    from ransacflow_tpu_torch.models.heads import pred_flow_coarse, pred_matchability

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(19)
    resnet, align = _nets("cuda")
    paths, readings = {}, {}
    readings["pred_heads_max_abs_err"], paths["surface_pred_heads"] = \
        _pred_heads_against_plain(align, gen)

    corr = torch.rand(SURFACE_HEADS, generator=gen, device="cuda").requires_grad_()
    grid = 2.2 * torch.rand((1, 480, 640, 2), generator=gen, device="cuda") - 1.1

    def flow_step():
        mag, out_grid = pred_flow_coarse(align["netFlowCoarse"], corr, grid)
        torch.autograd.grad((mag.sum() + out_grid.sum(),), [corr])

    def match_forward():
        with torch.no_grad():
            pred_matchability(align["netMatch"], corr)

    readings["pred_flow_coarse_fwd_bwd"] = {"ms": cuda_ms(flow_step, 10),
                                            "device_ms": device_ms(flow_step, 10)}
    readings["pred_matchability_fwd"] = {"ms": cuda_ms(match_forward, 10),
                                         "device_ms": device_ms(match_forward, 10)}
    readings["ops_max_abs_err"] = _surface_ops_against_cpu(gen)
    with tempfile.TemporaryDirectory() as tmp:
        readings["demo"], paths["surface_demo"] = _demo_on_card(tmp)
        readings["profile_trace"], paths["surface_traced_serving"] = \
            _traced_serving(tmp, resnet, align)
    readings["seconds"] = time.perf_counter() - t0
    for key, val in readings.items():
        print(f"(o) {key}: {val}", flush=True)
    print(f"(o) launches: {paths}; phase (o) {readings['seconds']:.1f} s on {card}",
          flush=True)
    return paths, readings


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
    "correlation_pair": ("cuda", "ransacflow_tpu_torch/csrc/correlation.cu",
                         "ransacflow_tpu/ops/correlation.py:21"),
    "head_epilogues": ("cuda", "ransacflow_tpu_torch/csrc/heads.cu",
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
    "head_epilogues_bwd": ("cuda", "ransacflow_tpu_torch/csrc/heads.cu",
                           "ransacflow_tpu/models/heads.py:69"),
    "anchor_resample": ("cuda", "ransacflow_tpu_torch/csrc/anchor_resample.cu",
                        "ransacflow_tpu/pipeline/coarse.py:70"),
    "ppm_pool": ("cuda", "ransacflow_tpu_torch/csrc/adaptive_pool.cu",
                 "ransacflow_tpu/models/segnet.py:148"),
    # replaces no TPU kernel: the frozen trunk's epilogue pass
    "conv_epilogue": ("cuda", "ransacflow_tpu_torch/csrc/conv_epilogue.cu", None),
    # replaces no TPU kernel: the frozen fine networks' convolutions
    "fine_conv": ("cuda", "ransacflow_tpu_torch/csrc/fine_conv.cu", None),
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
        evals, eval_readings = phase_eval(card, results)
        yfcc_paths, yfcc_readings = phase_yfcc(card)
        k_paths, k_readings = phase_affine_refine(card, results)
        l_paths, l_readings = phase_pool_bf16(card)
        m_paths, m_readings = phase_multicard(card, results)
        n_paths, n_readings = phase_batch_modes(card)
        o_paths, o_readings = phase_surface(card)
    except Exception:  # the boundary: report and fail
        traceback.print_exc()
        return 1
    by_path = {"serving": serving, **multihomo, "train": train, **fast, **sky, **evals,
               **yfcc_paths, **k_paths, **l_paths, **m_paths, **n_paths, **o_paths}
    kernels = [{"name": name, "route": route, "source": src, "replaces": rep,
                "launches": sum(p[name] for p in by_path.values()),
                "launches_by_path": {path: p[name] for path, p in by_path.items()},
                **{key: results[name][key] for key in
                   ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "device_ms", "plain_device_ms", "library_device_ms", "share")}}
               for name, (route, src, rep) in SOURCES.items()]
    print(json.dumps({"multihomo": readings, "train": train_readings,
                      "fast_modes": fast_readings, "sky": sky_readings,
                      "eval": {**eval_readings, **yfcc_readings},
                      "affine_refine_validation": k_readings,
                      "pool_bf16_remat": l_readings, "multicard": m_readings,
                      "batch_modes": n_readings, "surface": o_readings,
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
