"""Two-image alignment demo CLI (port of `ransacflow_tpu/cli/align.py`).

Usage:
  python -m ransacflow_tpu_torch.cli.align --img1 a.jpg --img2 b.jpg \
      --outdir out/ [--resumePth model.pth] [--device cuda]

Writes the fine-aligned source, the resized target, the coarse and fine
blends and H21.npy.
"""

import argparse
import os

import numpy as np
from PIL import Image

from ransacflow_tpu_torch.cli.common import (
    add_adaptive_flag,
    add_model_args,
    load_align_params,
    load_coarse_net,
)
from ransacflow_tpu_torch.pipeline.api import RansacFlowAligner


def save_blend(a, b, path):
    """50/50 blend of two (H, W, 3) float arrays, saved as PNG."""
    mean = np.clip((a * 0.5 + b * 0.5) * 255, 0, 255).astype(np.uint8)
    Image.fromarray(mean).save(path)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Align two images")
    parser.add_argument("--img1", type=str, required=True, help="source image path")
    parser.add_argument("--img2", type=str, required=True, help="target image path")
    parser.add_argument("--outdir", type=str, default="output/")
    add_model_args(parser)
    parser.add_argument("--nbScale", type=int, default=7)
    parser.add_argument("--coarseIter", type=int, default=10000)
    parser.add_argument("--coarsetolerance", type=float, default=0.05)
    parser.add_argument("--minSize", type=int, default=400)
    parser.add_argument("--scaleR", type=float, default=1.2)
    add_adaptive_flag(parser)
    args = parser.parse_args(argv)

    aligner = RansacFlowAligner(
        load_align_params(args.resumePth, args.device, args.kernelSize),
        load_coarse_net(args.device, args.mocoPth, args.imageNetPth),
        args.device,
        kernel_size=args.kernelSize,
        nb_scale=args.nbScale,
        n_iter=args.coarseIter,
        tolerance=args.coarsetolerance,
        min_size=args.minSize,
        scale_r=args.scaleR,
        adaptive_chunk=args.adaptiveChunk,
        anchor_stride=args.anchorStride,
        relax_cells=args.relaxCells,
    )
    img1 = Image.open(args.img1).convert("RGB")
    img2 = Image.open(args.img2).convert("RGB")
    out = aligner.align_images(img1, img2)
    if out["H21"] is None:
        print("No coarse homography found.")
        return

    os.makedirs(args.outdir, exist_ok=True)
    tgt = out["target"]
    fine = np.clip(out["warped_fine"] * 255, 0, 255).astype(np.uint8)
    Image.fromarray(fine).save(os.path.join(args.outdir, "fine_aligned_source.png"))
    Image.fromarray((tgt * 255).astype(np.uint8)).save(
        os.path.join(args.outdir, "resized_target.png"))
    save_blend(out["warped_coarse"], tgt, os.path.join(args.outdir, "comb_coarse_alignment.png"))
    save_blend(out["warped_fine"], tgt, os.path.join(args.outdir, "comb_fine_alignment.png"))
    np.save(os.path.join(args.outdir, "H21.npy"), out["H21"])
    print(f"Aligned. H21 =\n{out['H21']}\nOutputs in {args.outdir}")


if __name__ == "__main__":
    main()
