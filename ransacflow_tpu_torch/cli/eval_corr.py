"""MegaDepth/RobotCar sparse-correspondence harness CLI (port of
`ransacflow_tpu/cli/eval_corr.py`).

  python -m ransacflow_tpu_torch.cli.eval_corr predict --testCSV pairs.csv \
      --testDir imgs/ --outDir pred/ [--resumePth model.pth] [--device cuda]
  python -m ransacflow_tpu_torch.cli.eval_corr results --predDir pred/ \
      --testCSV pairs.csv --testDir imgs/ --dataset MegaDepth --multiH [--device cuda]

With --segNet the sky network reads each pair's target image (the JAX
package's CLI hands it the CSV row: `ROADMAP.md` queue 3).
"""

import argparse

from ransacflow_tpu_torch.cli.common import (
    add_adaptive_flag,
    add_batch_pairs_flag,
    add_compute_dtype_flag,
    add_fused_flag,
    add_model_args,
    add_segnet_args,
    build_sky_fn,
    cast_for_dtype,
    load_align_params,
    load_coarse_net,
    resolve_n_devices,
)
from ransacflow_tpu_torch.device import use_full_fp32
from ransacflow_tpu_torch.eval.corr import PIXEL_GRID, evaluate_corr, predict_corr


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("predict")
    add_model_args(p)
    add_segnet_args(p)
    p.add_argument("--testCSV", type=str, required=True)
    p.add_argument("--testDir", type=str, required=True)
    p.add_argument("--outDir", type=str, required=True)
    p.add_argument("--coarseIter", type=int, default=10000)
    p.add_argument("--maskRegionTh", type=float, default=0.01)
    p.add_argument("--maxCoarse", type=int, default=10)
    p.add_argument("--coarsetolerance", type=float, default=0.05)
    p.add_argument("--nbScale", type=int, default=7)
    p.add_argument("--minSize", type=int, default=480)
    p.add_argument("--scaleR", type=float, default=2.0)
    p.add_argument("--beginIndex", type=int, default=0)
    p.add_argument("--nDevices", type=int, default=None,
                   help="a pool of this many slots, one a card (cuda:0 ... "
                        "cuda:n-1, raises when the machine has fewer), each "
                        "pair on the device-resident multi-homography loop. "
                        "Default: the host loop")
    add_batch_pairs_flag(p)
    p.add_argument("--endIndex", type=int, default=None)
    add_fused_flag(p)
    add_adaptive_flag(p)
    add_compute_dtype_flag(p)

    r = sub.add_parser("results")
    r.add_argument("--predDir", type=str, required=True)
    r.add_argument("--testCSV", type=str, required=True)
    r.add_argument("--testDir", type=str, required=True)
    r.add_argument("--dataset", type=str, default="MegaDepth",
                   choices=["MegaDepth", "RobotCar"])
    r.add_argument("--multiH", action="store_true")
    r.add_argument("--th", type=float, default=0.95)
    r.add_argument("--minSize", type=int, default=480)
    r.add_argument("--matchabilityTH", type=float, nargs="+", default=[0.0])
    r.add_argument("--strictRefBug", action="store_true",
                   help="reproduce the reference's missing-pair accounting "
                        "bit for bit (evalCorr/getResults.py:275-278), "
                        "its loop-variable leak included")
    r.add_argument("--device", type=str, default="cuda",
                   help="the torch device the flows are composed on")

    args = parser.parse_args(argv)
    if args.cmd == "predict":
        n_devices = resolve_n_devices(args)
    use_full_fp32()

    if args.cmd == "predict":
        predict_corr(
            args.testCSV, args.testDir, args.outDir,
            cast_for_dtype(load_coarse_net(args.device, args.mocoPth, args.imageNetPth),
                           args.computeDtype),
            cast_for_dtype(load_align_params(args.resumePth, args.device, args.kernelSize),
                           args.computeDtype),
            args.device,
            min_size=args.minSize, nb_scale=args.nbScale,
            n_iter=args.coarseIter, tolerance=args.coarsetolerance,
            scale_r=args.scaleR, max_coarse=args.maxCoarse,
            mask_region_th=args.maskRegionTh,
            begin_index=args.beginIndex, end_index=args.endIndex,
            bg_mask_fn=build_sky_fn(args, args.device),
            n_devices=n_devices, batch_pairs=args.batchPairs,
            adaptive_chunk=args.adaptiveChunk,
            anchor_stride=args.anchorStride,
            relax_cells=args.relaxCells,
        )
    else:
        res = evaluate_corr(
            args.predDir, args.testCSV, args.testDir, args.device,
            dataset=args.dataset, min_size=args.minSize, multi_h=args.multiH,
            th=args.th, matchability_th=tuple(args.matchabilityTH),
            strict_ref_bug=args.strictRefBug,
        )
        print("pixel thresholds:", PIXEL_GRID)
        for mth, (prec, total) in res.items():
            print(f"threshold {mth:.1f}, precision {prec}, n={total}")


if __name__ == "__main__":
    main()
