"""Coarse-aligned training-pair generation (the reference notebook
train/generate_coarse_aligned_pair.ipynb as a CLI; port of
`ransacflow_tpu/cli/generate_pairs.py`).

For each input pair: 3-scale (x0.5, x1, x2) coarse features, mutual
matching (kernel 2), RANSAC homography (kernel 3); if the winner has more
than --minInliers inliers, the second image is warped onto the first's
frame (kernel 5's homography form) and the pair is written as
``{index}_1.jpg`` / ``{index}_2.jpg``, the PairFolder training layout.

  python -m ransacflow_tpu_torch.cli.generate_pairs --pairCSV pairs.csv \
      --imgDir imgs/ --outDir train_pairs/ [--mocoPth resnet50_moco.pth] [--device cuda]

pairCSV columns: imgA, imgB (paths relative to --imgDir).
"""

import argparse
import os

import numpy as np
import torch
from PIL import Image

from ransacflow_tpu_torch.cli.common import add_model_args, load_coarse_net
from ransacflow_tpu_torch.device import as_device, use_full_fp32
from ransacflow_tpu_torch.eval.table import read_rows
from ransacflow_tpu_torch.kernels.warp_sample import warp_homography
from ransacflow_tpu_torch.ops.grid import feature_cell_coords
from ransacflow_tpu_torch.ops.matching import mutual_matching
from ransacflow_tpu_torch.ops.ransac import ransac_homography
from ransacflow_tpu_torch.pipeline.coarse import _coarse_feats
from ransacflow_tpu_torch.utils.image import STRIDE_NET, resize_round_stride, to_array


def _feats_and_coords(resnet, arr, device):
    """A resized image's L2-normalized coarse features (n, 1024) and its
    cells' normalized (x, y) coords (n, 2)."""
    feats = _coarse_feats(resnet, torch.as_tensor(arr, device=device)[None])
    y, x = feature_cell_coords(arr.shape[0] // STRIDE_NET, arr.shape[1] // STRIDE_NET, device)
    return feats, torch.stack([x, y], dim=1)


@torch.inference_mode()
def pair_matches(resnet, img1, img2, device, min_size=480):
    """The bank of img1 at x0.5, x1 and x2 of min_size, mutually matched to
    img2 at min_size. Returns (MatchResult keyed by img2's cells, img1's
    bank coords (nA, 2), img2's cell coords (nB, 2), resized img1 array,
    resized img2 array)."""
    device = as_device(device)
    feats, coords = zip(*(_feats_and_coords(resnet, to_array(resize_round_stride(img1, s)),
                                            device)
                          for s in (min_size // 2, min_size, min_size * 2)))
    arr1 = to_array(resize_round_stride(img1, min_size))
    arr2 = to_array(resize_round_stride(img2, min_size))
    f2, coords2 = _feats_and_coords(resnet, arr2, device)
    m = mutual_matching(torch.cat(feats).T, f2.T)
    return m, torch.cat(coords), coords2, arr1, arr2


@torch.inference_mode()
def align_pair(resnet, img1, img2, generator, device, min_size=480, n_iter=10000,
               tolerance=0.05):
    """Returns (n_inliers, H21 mapping img1 coords -> img2 coords (3, 3)
    float32, resized img1 array, resized img2 array). generator: the
    `torch.Generator` (on `device`) the RANSAC draws come from."""
    m, coords1, coords2, arr1, arr2 = pair_matches(resnet, img1, img2, device, min_size)
    ones = torch.ones((coords2.shape[0], 1), dtype=torch.float32, device=coords2.device)
    # fit the map from img1 (multi-scale bank) coords to img2 coords so the
    # warp grid samples img2 on img1's frame
    m_src = torch.cat([coords2, ones], dim=1)
    m_tgt = torch.cat([coords1[m.src_idx.long()], ones], dim=1)
    res = ransac_homography(m_src, m_tgt, m.valid, tolerance, n_iter=n_iter,
                            generator=generator)
    return int(res.num_inliers), res.H21.cpu().numpy(), arr1, arr2


@torch.inference_mode()
def warp_to_first(arr2, H21, hw, device):
    """img2 sampled on img1's (H, W) frame through H21, (H, W, 3) float32."""
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)[None]  # noqa: E731
    return warp_homography(put(arr2), put(H21.astype(np.float32)), hw)[0][0].cpu().numpy()


def _save(arr, path):
    Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8)).save(path)


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_model_args(parser)
    parser.add_argument("--pairCSV", type=str, required=True)
    parser.add_argument("--imgDir", type=str, required=True)
    parser.add_argument("--outDir", type=str, required=True)
    parser.add_argument("--minSize", type=int, default=480)
    parser.add_argument("--nbIter", type=int, default=10000)
    parser.add_argument("--tolerance", type=float, default=0.05)
    parser.add_argument("--minInliers", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0,
                        help="row i's RANSAC draws come from SeedSequence([seed, i])")
    args = parser.parse_args(argv)
    use_full_fp32()

    device = as_device(args.device)
    resnet = load_coarse_net(device, args.mocoPth, args.imageNetPth)
    rows = read_rows(args.pairCSV)
    os.makedirs(args.outDir, exist_ok=True)

    kept = 0
    for i, row in enumerate(rows):
        img1 = Image.open(os.path.join(args.imgDir, row["imgA"])).convert("RGB")
        img2 = Image.open(os.path.join(args.imgDir, row["imgB"])).convert("RGB")
        seed = np.random.SeedSequence([args.seed, i]).generate_state(1, np.uint64)[0]
        generator = torch.Generator(device).manual_seed(int(seed))
        n_inl, H21, arr1, arr2 = align_pair(resnet, img1, img2, generator, device,
                                            args.minSize, args.nbIter, args.tolerance)
        if n_inl <= args.minInliers:
            continue
        _save(arr1, os.path.join(args.outDir, f"{kept}_1.jpg"))
        _save(warp_to_first(arr2, H21, arr1.shape[:2], device),
              os.path.join(args.outDir, f"{kept}_2.jpg"))
        kept += 1
    print(f"kept {kept}/{len(rows)} pairs (> {args.minInliers} inliers)")


if __name__ == "__main__":
    main()
