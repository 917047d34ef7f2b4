"""No-dataset demo: align a synthetically translated pair end to end (port
of `examples/synthetic_demo.py`).

Builds a blocky image, warps it by a known one-cell translation, runs the
public aligner (coarse homography and one fine flow pass) with seeded
weights, and reports how well the known transform was recovered, with three
blends written as PNGs.

  python -m ransacflow_tpu_torch.examples.synthetic_demo [--outdir demo_out] [--device cuda]

With released checkpoints, pass --resumePth / --imageNetPth for trained
fine alignment.
"""

import argparse
import os

import numpy as np
import torch
from PIL import Image

from ransacflow_tpu_torch.cli.align import save_blend
from ransacflow_tpu_torch.cli.common import load_align_params, load_coarse_net
from ransacflow_tpu_torch.device import as_device
from ransacflow_tpu_torch.kernels.warp_sample import warp_sample
from ransacflow_tpu_torch.models.convert import init_alignment_params, init_resnet50_layer3
from ransacflow_tpu_torch.ops.homography import apply_homography, warp_grid
from ransacflow_tpu_torch.pipeline.api import RansacFlowAligner


def translated_pair(s, device):
    """The demo's pair: a blocky (s, s, 3) source and its copy moved by one
    16-pixel feature cell along both axes, with the true H21 (normalized,
    target -> source). Returns (source array, target array, h_true)."""
    rng = np.random.RandomState(0)
    base = (rng.rand(s // 4, s // 4, 3) > 0.5).astype(np.float32)
    src_arr = np.kron(base, np.ones((4, 4, 1), np.float32))[:s, :s]
    # one feature cell (16 px) of translation: recoverable even with seeded
    # features (tests/test_pipeline.py says why)
    t = 2 * 16.0 / s
    h_true = np.array([[1, 0, t], [0, 1, t], [0, 0, 1]], np.float32)
    grid = warp_grid(torch.from_numpy(h_true).to(device)[None], s, s)
    tgt = warp_sample(torch.from_numpy(src_arr).to(device)[None], grid.contiguous())
    return src_arr, tgt[0].cpu().numpy(), h_true


def main(argv=None):
    """Run the demo. Returns (recovered H21 normalized to H[2, 2] = 1, mean
    grid error in pixels), or (None, None) when no homography was found."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--outdir", type=str, default="demo_out")
    parser.add_argument("--resumePth", type=str, default=None)
    parser.add_argument("--imageNetPth", type=str, default=None)
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--device", type=str, default="cuda",
                        help="the torch device to run on")
    args = parser.parse_args(argv)
    device = as_device(args.device)

    s = args.size
    src_arr, tgt_arr, h_true = translated_pair(s, device)
    src = Image.fromarray((src_arr * 255).astype(np.uint8))
    tgt = Image.fromarray((np.clip(tgt_arr, 0, 1) * 255).astype(np.uint8))

    if args.resumePth:
        align = load_align_params(args.resumePth, device)
        resnet = load_coarse_net(device, imagenet_path=args.imageNetPth)
    else:
        print("using random-init nets (pass --resumePth for trained quality)")
        align = init_alignment_params(torch.Generator().manual_seed(0), device)
        resnet = init_resnet50_layer3(torch.Generator().manual_seed(1), device)

    aligner = RansacFlowAligner(align, resnet, device, nb_scale=1, n_iter=3000,
                                min_size=s, resize_mode="min")
    border = np.ones((s, s), np.float32)
    border[s // 5: -s // 5, s // 5: -s // 5] = 0  # exclude image borders
    out = aligner.align_images(src, tgt, exclusion_mask=border)
    if out["H21"] is None:
        print("no homography found")
        return None, None

    h_est = out["H21"] / out["H21"][2, 2]
    pts = torch.from_numpy(np.random.RandomState(1).rand(64, 2).astype(np.float32) * 1.2 - 0.6)
    a = apply_homography(torch.from_numpy(h_est), pts).numpy()
    b = apply_homography(torch.from_numpy(h_true), pts).numpy()
    err_px = float(np.abs(a - b).mean() * (s - 1) / 2)

    os.makedirs(args.outdir, exist_ok=True)
    save_blend(src_arr, out["target"], os.path.join(args.outdir, "before.png"))
    save_blend(out["warped_coarse"], out["target"], os.path.join(args.outdir, "after_coarse.png"))
    save_blend(out["warped_fine"], out["target"], os.path.join(args.outdir, "after_fine.png"))
    print(f"true H (normalized):\n{h_true}")
    print(f"recovered H:\n{np.round(h_est, 4)}")
    print(f"mean grid error: {err_px:.2f} px at {s}px")
    print(f"visualizations in {args.outdir}/")
    return h_est, err_px


if __name__ == "__main__":
    main()
