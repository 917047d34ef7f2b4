#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port once on one CUDA card: the serving path and
the multi-homography loop.

    python3 chip_smoke.py

Phases, each of which must pass:
  (a) card: a CUDA device is present; prints its name and power limit;
  (b) build: compiles the CUDA kernels from `ransacflow_tpu_torch/csrc/`;
  (c) kernels: each hand-written kernel (K2-K8) against its plain PyTorch
      version at its path's shapes, with max error and paired times (CUDA
      events); K4 runs under sync-debug 'error';
  (d) serving path: `fused_align_batch` over 4 pairs at full width (480x640
      targets, 7-scale pyramid from 960x1280, 10k RANSAC hypotheses, fp32,
      seeded weights), checked for finite outputs, against the plain CPU path
      on a small pair, and for launches of its kernels: mutual_argmax (K2),
      ransac_score (K3), warp_sample (K5), correlation_volume (K6),
      head_epilogues (K7) and compose_tail (K8); prints pairs/s;
  (e) multi-homography path: `_fused_multi_homo_batch` at bench.py's
      HPatches configuration (4 related pairs, 480x640 targets, 7-scale
      pyramid from 960x1280, max_coarse 10, mask_region_th 0.01, match12
      only, cached matching, seeded trunk, alignment nets from
      scripts/assets/accept_weights.npz), once with adaptive RANSAC (blocks
      of 4096, cap 50k) and once with 50k fixed hypotheses, checked for
      finite outputs, 1 <= count <= 11 and launches of all seven kernels
      (K2-K8, ransac_adaptive K4 added); prints pairs/s, homographies and
      hypotheses per fit and a one-slot stage split; then, on one pair
      from PIL images, the host loop (`CoarseAligner` +
      `multi_homography_predict`) and the device loop through
      `multi_homography_predict_fused` on the same aligner and seed, whose
      first homographies must agree within 0.01.
Each path's launch counts are set to 0 just before it and read just after.

Its last three lines are the card (nvidia-smi name, power limit), a JSON
object with the kernels' numbers, and `{"ok": true, "device": {...}}`. It
exits non-zero, without that last line, on any failure or without CUDA.
"""

import json
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
SERVING_KERNELS = ("mutual_argmax", "ransac_score", "warp_sample",
                   "correlation_volume", "head_epilogues", "compose_tail")
MULTIHOMO_KERNELS = SERVING_KERNELS + ("ransac_adaptive",)


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
                        lambda: correlation_volume_ref(x, y, 7))}


def check_matching(gen):
    from ransacflow_tpu_torch.kernels.matching import mutual_argmax, mutual_argmax_ref

    feat_a = _normalized((N_CHANNELS, N_BANK), 0, gen)
    feat_b = _normalized((N_CHANNELS, N_TARGET), 0, gen)
    feat_a[:, 101] = feat_a[:, 57]  # bank rows 57 and 101 tie exactly ...
    feat_b[:, 5] = feat_a[:, 57]    # ... as the best source of target 5
    valid_b = torch.rand(N_TARGET, generator=gen, device="cuda") > 0.1
    valid_b[5] = True
    score = (feat_a.T @ feat_b) * valid_b.float()[None, :]
    require(score[57, 5].item() == score[101, 5].item(), "planted tie is not exact")
    got = mutual_argmax(score)
    want = mutual_argmax_ref(score)
    torch.cuda.synchronize()
    for name, g, w in zip(("best_src", "best_tgt", "valid"), got[:3], want[:3]):
        require(torch.equal(g, w), f"matching: {name} differs from the plain version")
    require(got[0][5].item() == 57, "matching: the tie did not go to the lowest index")
    require(not got[2][~valid_b].any().item(), "matching: a masked target matched")
    err = (got[3] - want[3]).abs().max().item()
    return {"max_abs_err": err, **paired_ms(lambda: mutual_argmax(score),
                                            lambda: mutual_argmax_ref(score))}


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
    return {"max_abs_err": err, "counts_agree": agree,
            **paired_ms(lambda: ransac_score(m1, m2, valid, samples, 0.05),
                        lambda: ransac_score_ref(m1, m2, valid, samples, 0.05))}


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
        out.update(paired_ms(lambda: ransac_adaptive(*args),
                             lambda: ransac_adaptive_ref(*args), reps=5,
                             suffix="" if case == "clean" else "_to_cap"))
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
    return {"max_abs_err": err, **paired_ms(lambda: warp_sample(src, grid),
                                            lambda: warp_sample_ref(src, grid))}


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
    return {"max_abs_err": err, **paired_ms(
        lambda: (flow_epilogue(flow_logits, 7), match_epilogue(match_logits)),
        lambda: (flow_epilogue_ref(flow_logits, 7), match_epilogue_ref(match_logits)))}


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
    return out


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {"correlation_volume": check_correlation(gen),
               "mutual_argmax": check_matching(gen),
               "ransac_score": check_ransac(gen),
               "ransac_adaptive": check_ransac_adaptive(gen),
               "warp_sample": check_warp_sample(gen),
               "head_epilogues": check_head_epilogues(gen),
               "compose_tail": check_compose_tail(gen)}
    for name, r in results.items():
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


def check_small_pair_against_cpu():
    """The port on the card against its plain CPU path (held against the JAX
    package by tests/test_torch_pipeline.py), one 64x64 pair, same draws."""
    from ransacflow_tpu_torch.pipeline.fused import device_pyramid, fused_align

    rng = np.random.RandomState(3)
    src = torch.from_numpy(_blocky(rng, 1, 128, 128))
    tgt = torch.from_numpy(_blocky(rng, 1, 64, 64))
    samples = torch.from_numpy(rng.randint(0, 16, (256, 4)).astype(np.int32))
    outs = {}
    for device in ("cpu", "cuda"):
        resnet, align = _nets(device)
        pyr = device_pyramid(src.to(device), [(128, 128), (64, 64), (32, 32)])
        outs[device] = fused_align(resnet, align, pyr, tgt.to(device), n_iter=256,
                                   injected_samples=samples.to(device))
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
    # cuDNN and CPU convolutions sum in other orders (fp32, TF32 off)
    require(errs["H21"] <= 1e-4 and errs["flow"] <= 1e-3 and errs["match"] <= 1e-3,
            f"small pair: differs from CPU: {errs}")
    return errs


def phase_serving(card):
    from ransacflow_tpu_torch import kernels
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

    kernels.reset_launch_counts()
    out = serve()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    require(all(launches[k] > 0 for k in SERVING_KERNELS),
            f"serving path: kernel not launched: {launches}")
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
    return launches


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
    empty mask), from CUDA events recorded between the stages."""
    from ransacflow_tpu_torch.kernels.compose import compose_tail
    from ransacflow_tpu_torch.kernels.correlation import correlation_volume
    from ransacflow_tpu_torch.kernels.warp_sample import warp_sample
    from ransacflow_tpu_torch.models.feature_extractor import feature_extractor
    from ransacflow_tpu_torch.models.heads import net_flow_coarse, net_matchability
    from ransacflow_tpu_torch.models.layers import l2_normalize
    from ransacflow_tpu_torch.ops.homography import warp_grid
    from ransacflow_tpu_torch.ops.ransac import ransac_homography, ransac_homography_adaptive
    from ransacflow_tpu_torch.pipeline.coarse import (
        _homogeneous_matches, _mask_to_cells, _match_masked)

    ht, wt = TARGET_HW
    gen = torch.Generator(device="cuda").manual_seed(0)
    names = ("mask_and_matches", "ransac", "warp", "fine_features", "correlation",
             "heads", "compose")
    samples = []
    for _ in range(reps + 1):  # the first is a warm-up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        cells = _mask_to_cells(torch.zeros((ht, wt), device="cuda"), ht // 16, wt // 16)
        idx, ok = _match_masked(bank, featt, cells, src_idx, valid, False)
        m1, m2 = _homogeneous_matches(coords_a, coords_b, idx)
        ev[1].record()
        if adaptive_chunk:
            res, _ = ransac_homography_adaptive(m1, m2, ok, 0.05, MH_N_ITER,
                                                adaptive_chunk, generator=gen)
        else:
            res = ransac_homography(m1, m2, ok, 0.05, MH_N_ITER, generator=gen)
        ev[2].record()
        grid = warp_grid(res.H21[None], ht, wt)
        src_warp = warp_sample(src, grid)
        ev[3].record()
        feats = l2_normalize(feature_extractor(align["netFeatCoarse"], src_warp))
        ev[4].record()
        corr12 = correlation_volume(featt_fine, feats, 7)
        corr21 = correlation_volume(feats, featt_fine, 7)
        ev[5].record()
        flow8 = net_flow_coarse(align["netFlowCoarse"], corr12, up8=False)
        m12 = net_matchability(align["netMatch"], corr12, up8=False)
        m21 = net_matchability(align["netMatch"], corr21, up8=False)
        ev[6].record()
        compose_tail(flow8, m12, m21, grid, False)
        ev[7].record()
        ev[7].synchronize()
        samples.append([ev[i].elapsed_time(ev[i + 1]) for i in range(len(names))])
    med = np.median(np.array(samples[1:]), axis=0)
    return {name: float(v) for name, v in zip(names, med)}


def phase_multihomo(card):
    from PIL import Image

    from ransacflow_tpu_torch import kernels
    from ransacflow_tpu_torch.models.convert import (
        alignment_params_from_tree, init_resnet50_layer3, load_params_npz)
    from ransacflow_tpu_torch.ops.grid import feature_cell_coords
    from ransacflow_tpu_torch.ops.matching import mutual_matching
    from ransacflow_tpu_torch.pipeline import (
        CoarseAligner, multi_homography_predict, multi_homography_predict_fused)
    from ransacflow_tpu_torch.pipeline.coarse import _coarse_feats
    from ransacflow_tpu_torch.pipeline.fine import fine_features
    from ransacflow_tpu_torch.pipeline.fused import _bank_coords, device_pyramid
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
    coords_a, coords_b = _bank_coords(shapes, "cuda"), torch.stack([x, y], dim=1)

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
    kernels.reset_launch_counts()
    outs = {name: run(chunk) for name, chunk in series.items()}
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    require(all(launches[k] > 0 for k in MULTIHOMO_KERNELS),
            f"multi-homography path: kernel not launched: {launches}")
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
    print(f"(e) launches (both series): {launches}", flush=True)
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


SOURCES = {
    "mutual_argmax": ("cuda", "ransacflow_tpu_torch/csrc/matching.cu",
                      "ransacflow_tpu/ops/matching.py:24"),
    "ransac_score": ("cuda", "ransacflow_tpu_torch/csrc/ransac.cu",
                     "ransacflow_tpu/ops/ransac.py:102"),
    "ransac_adaptive": ("cuda", "ransacflow_tpu_torch/csrc/ransac_adaptive.cu",
                        "ransacflow_tpu/ops/ransac.py:194"),
    "warp_sample": ("cuda", "ransacflow_tpu_torch/csrc/warp_sample.cu",
                    "ransacflow_tpu/ops/sampler.py:240"),
    "correlation_volume": ("cuda", "ransacflow_tpu_torch/csrc/correlation.cu",
                           "ransacflow_tpu/ops/correlation.py:21"),
    "head_epilogues": ("triton", "ransacflow_tpu_torch/kernels/heads_triton.py",
                       "ransacflow_tpu/models/heads.py:69"),
    "compose_tail": ("cuda", "ransacflow_tpu_torch/csrc/compose.cu",
                     "ransacflow_tpu/pipeline/fine.py:61"),
}


def main():
    try:
        card = phase_card()
        phase_build()
        results = phase_kernels()
        serving = phase_serving(card)
        launches, readings = phase_multihomo(card)
    except Exception:  # the boundary: report and fail
        traceback.print_exc()
        return 1
    kernels = [{"name": name, "route": route, "source": src, "replaces": rep,
                "launches": launches[name],
                "launches_by_path": {"serving": serving[name], "multihomo": launches[name]},
                **{key: results[name][key] for key in
                   ("max_abs_err", "ms", "plain_ms", "device_ms", "plain_device_ms")}}
               for name, (route, src, rep) in SOURCES.items()]
    print(json.dumps({"multihomo": readings}))
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
