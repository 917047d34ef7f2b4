#!/usr/bin/env python3
"""The single-pair forms of kernels 2, 3, 4 and 12 of `ransacflow_tpu_torch`
and its `scan` serving loop, timed on one CUDA card, for comparing two
checkouts in one machine.

    cd <checkout> && python3 <this script> [LABEL]

Runs the port of the checkout it is started from (its `ransacflow_tpu_torch`,
built at first use) on inputs made from seeds: kernel 2's epilogue on a
serving score (13,065 x 1,200, unmasked and masked); kernel 3, the kernel
alone and the op that paths call (the seed draw and the fit), 1,200 matches
(60% inliers, 10% invalid), 10k hypotheses; kernel 4 likewise on
structureless matches, blocks of 4,096 to the cap of 50k (13 blocks);
kernel 12's 7-scale stride-3 bank of one pair. Each: `ms`, the median of 5
rounds of CUDA events over 50 back-to-back calls (host launch time
included; `ms_min` the least round), and `device_ms`, the kernels' own
time in a torch.profiler trace of 50 calls. Then
`fused_align_batch` in its default mode (`scan`) over 4 full-width pairs
(480x640 targets, 7 scales from 960x1280, 10k hypotheses, seeded weights),
fp32 (TF32 off) and bf16: pairs/s, the best of 5 CUDA-event times after a
warm-up. Prints one JSON line, LABEL and the card's name and power limit
beside the readings.
"""

import json
import os
import subprocess
import sys

import numpy as np

REPS = 50
ROUNDS = 5
N_BANK, N_TARGET, N_CHANNELS = 13065, 1200, 1024
N_ITER, CAP, CHUNK = 10000, 50000, 4096
N_PAIRS, TARGET_HW = 4, (480, 640)


def _timed(fn):
    """ms of fn(): the median and the least of ROUNDS rounds of CUDA events
    over REPS back-to-back calls, after 3 warm-up calls; device_ms: the
    device time of a profiler trace of REPS calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    rounds = []
    for _ in range(ROUNDS):
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        rounds.append(start.elapsed_time(end) / REPS)
    rounds.sort()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages())
    return {"ms": rounds[ROUNDS // 2], "ms_min": rounds[0],
            "device_ms": device_us / 1e3 / REPS if device_us > 0 else None}


def _matches(gen, inlier_frac):
    """1,200 target cells (30 x 40), `inlier_frac` of them inliers of a
    known homography, 10% invalid."""
    import torch

    from ransacflow_tpu_torch.ops.grid import feature_cell_coords
    from ransacflow_tpu_torch.ops.homography import apply_homography

    y, x = feature_cell_coords(30, 40, "cuda")
    m2 = torch.stack([x, y, torch.ones_like(x)], dim=1)
    h_true = torch.tensor([[1.05, 0.02, 0.03], [-0.01, 0.97, -0.02], [0.02, -0.03, 1.0]],
                          device="cuda")
    m1 = apply_homography(h_true, m2[:, :2])
    m1 = m1 + 0.005 * torch.randn(m1.shape, generator=gen, device="cuda")
    outlier = torch.rand(N_TARGET, generator=gen, device="cuda") >= inlier_frac
    m1[outlier] = torch.rand((int(outlier.sum()), 2), generator=gen, device="cuda") * 2 - 1
    m1 = torch.cat([m1, torch.ones_like(m1[:, :1])], dim=1).contiguous()
    return m1, m2, torch.rand(N_TARGET, generator=gen, device="cuda") > 0.1


def kernels(gen):
    import torch

    from ransacflow_tpu_torch.kernels.anchor_resample import anchor_resample_bank
    from ransacflow_tpu_torch.kernels.matching import mutual_argmax
    from ransacflow_tpu_torch.kernels.ransac import ransac_fit
    from ransacflow_tpu_torch.kernels.ransac_adaptive import ransac_adaptive
    from ransacflow_tpu_torch.ops.ransac import (
        draw_seed, ransac_homography, ransac_homography_adaptive)
    from ransacflow_tpu_torch.pipeline.bank import nearest_anchors
    from ransacflow_tpu_torch.utils.image import pyramid_shapes

    out = {}
    feat_a = torch.nn.functional.normalize(
        torch.randn((N_CHANNELS, N_BANK), generator=gen, device="cuda"), dim=0)
    feat_b = torch.nn.functional.normalize(
        torch.randn((N_CHANNELS, N_TARGET), generator=gen, device="cuda"), dim=0)
    score = feat_a.T @ feat_b
    valid_b = torch.rand(N_TARGET, generator=gen, device="cuda") > 0.1
    out["k2"] = _timed(lambda: mutual_argmax(score))
    out["k2_masked"] = _timed(lambda: mutual_argmax(score, valid_b=valid_b))

    own = torch.Generator(device="cuda").manual_seed(N_ITER)
    m1, m2, valid = _matches(gen, 0.6)
    seed = draw_seed(gen, "cuda")
    out["k3_kernel"] = _timed(lambda: ransac_fit(m1, m2, valid, 0.05, N_ITER, seed=seed))
    out["k3_op"] = _timed(lambda: ransac_homography(m1, m2, valid, 0.05, N_ITER, generator=own))

    m1, m2, valid = _matches(gen, 0.0)
    args = (m1, m2, valid, 0.05, CAP, CHUNK, 0.999)
    _, n_eval, _ = ransac_adaptive(*args, seed=seed)
    out["k4_blocks"] = int(n_eval) // CHUNK
    out["k4_kernel_to_cap"] = _timed(lambda: ransac_adaptive(*args, seed=seed))
    out["k4_op_to_cap"] = _timed(lambda: ransac_homography_adaptive(
        m1, m2, valid, 0.05, CAP, CHUNK, generator=own))

    shapes = pyramid_shapes()
    nearest = nearest_anchors(shapes, 3)
    maps = {i: 3 * torch.randn((1, h // 16, w // 16, N_CHANNELS), generator=gen, device="cuda")
            for i, (h, w) in enumerate(shapes) if i in nearest}
    bank = torch.empty((sum((h // 16) * (w // 16) for h, w in shapes), N_CHANNELS),
                       device="cuda")
    out["k12_bank"] = _timed(lambda: anchor_resample_bank(maps, shapes, nearest, out=bank))
    return out


def serving():
    import torch

    from ransacflow_tpu_torch.cli.common import cast_for_dtype
    from ransacflow_tpu_torch.models.convert import init_resnet50_layer3
    from ransacflow_tpu_torch.pipeline import init_alignment_params
    from ransacflow_tpu_torch.pipeline.fused import device_pyramid, fused_align_batch
    from ransacflow_tpu_torch.utils.image import pyramid_shapes

    def blocky(rng, n, h, w):
        base = (rng.rand(n, h // 4, w // 4, 3) > 0.5).astype(np.float32)
        return np.kron(base, np.ones((1, 4, 4, 1), np.float32))[:, :h, :w]

    shapes = pyramid_shapes()
    rng = np.random.RandomState(0)
    sources = torch.from_numpy(blocky(rng, N_PAIRS, *shapes[0])).cuda()
    targets = torch.from_numpy(blocky(rng, N_PAIRS, *TARGET_HW)).cuda()[:, None]
    resnet = init_resnet50_layer3(torch.Generator().manual_seed(0), "cuda")
    align = init_alignment_params(torch.Generator().manual_seed(1), "cuda")
    out = {}
    for key in ("fp32", "bf16"):
        r, a = (resnet, align) if key == "fp32" else (cast_for_dtype(resnet, "bfloat16"),
                                                       cast_for_dtype(align, "bfloat16"))

        def serve():
            pyr = tuple(p[:, None] for p in device_pyramid(sources, shapes))
            return fused_align_batch(r, a, pyr, targets,
                                     torch.Generator(device="cuda").manual_seed(2),
                                     n_iter=N_ITER)

        res = serve()
        if not bool(torch.isfinite(res["H21"]).all()):
            raise RuntimeError(f"serving {key}: H21 not finite")
        best = float("inf")
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            serve()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        out[f"scan_{key}_pairs_s"] = N_PAIRS / (best / 1e3)
    return out


def main():
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    with torch.inference_mode():
        readings = kernels(torch.Generator(device="cuda").manual_seed(0))
        readings.update(serving())
    print(json.dumps({"label": sys.argv[1] if len(sys.argv) > 1 else os.getcwd(),
                      "card": card, **readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
