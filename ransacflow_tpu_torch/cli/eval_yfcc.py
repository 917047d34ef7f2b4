"""YFCC two-view geometry harness CLI (port of
`ransacflow_tpu/cli/eval_yfcc.py`): predict, then results.

  python -m ransacflow_tpu_torch.cli.eval_yfcc predict --testImg data/YFCC/images \
      --testPair data/YFCC/pairs --testScene reichstag --outDir pred/ [--device cuda]
  python -m ransacflow_tpu_torch.cli.eval_yfcc results --predDir pred/ \
      --gtPath data/YFCC/images --testPair data/YFCC/pairs \
      --scene 2 --multiH --ransac [--device cuda]

The results pass reads the scenes' .h5 calibration with h5py.
"""

import argparse
import json
import os

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
from ransacflow_tpu_torch.eval.yfcc import SCENES, evaluate_yfcc, predict_yfcc


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("predict")
    add_model_args(p)
    add_segnet_args(p)
    p.add_argument("--testImg", type=str, required=True)
    p.add_argument("--testPair", type=str, required=True)
    p.add_argument("--testScene", type=str, default=None, choices=SCENES)
    p.add_argument("--outDir", type=str, required=True)
    p.add_argument("--minSize", type=int, default=480)
    p.add_argument("--coarseIter", type=int, default=10000)
    p.add_argument("--maskRegionTh", type=float, default=0.01)
    p.add_argument("--maxCoarse", type=int, default=10)
    p.add_argument("--coarsetolerance", type=float, default=0.05)
    p.add_argument("--nbScale", type=int, default=7)
    p.add_argument("--scaleR", type=float, default=2.0)
    p.add_argument("--beginIndex", type=int, default=0)
    p.add_argument("--endIndex", type=int, default=1000)
    p.add_argument("--nDevices", type=int, default=None,
                   help="a pool of this many slots, one a card (cuda:0 ... "
                        "cuda:n-1, raises when the machine has fewer), each "
                        "pair on the device-resident multi-homography loop. "
                        "Default: the host loop")
    add_batch_pairs_flag(p)
    add_fused_flag(p)
    add_adaptive_flag(p)
    add_compute_dtype_flag(p)

    r = sub.add_parser("results")
    r.add_argument("--predDir", type=str, required=True)
    r.add_argument("--gtPath", type=str, required=True)
    r.add_argument("--testPair", type=str, required=True)
    r.add_argument("--scene", type=int, choices=[0, 1, 2, 3], required=True)
    r.add_argument("--multiH", action="store_true")
    r.add_argument("--ransac", action="store_true")
    r.add_argument("--threshold", type=float, default=0.0005)
    r.add_argument("--th", type=float, default=0.95)
    r.add_argument("--outRes", type=str, default="out.json")
    r.add_argument("--minSize", type=int, default=480,
                   help="the predict pass's --minSize (the matches' frame)")
    r.add_argument("--device", type=str, default="cuda",
                   help="the torch device the flows are composed and the pose "
                        "hypotheses scored on")

    args = parser.parse_args(argv)
    if args.cmd == "predict":
        n_devices = resolve_n_devices(args)
    use_full_fp32()

    if args.cmd == "predict":
        resnet = cast_for_dtype(load_coarse_net(args.device, args.mocoPth, args.imageNetPth),
                                args.computeDtype)
        align = cast_for_dtype(load_align_params(args.resumePth, args.device, args.kernelSize),
                               args.computeDtype)
        sky = build_sky_fn(args, args.device, rotated=True)
        for scene in [args.testScene] if args.testScene else list(SCENES):
            predict_yfcc(
                os.path.join(args.testPair, f"{scene}-te-1000-pairs.pkl"),
                os.path.join(args.testImg, scene, "test"),
                os.path.join(args.outDir, scene),
                resnet, align, args.device,
                min_size=args.minSize, nb_scale=args.nbScale,
                n_iter=args.coarseIter, tolerance=args.coarsetolerance,
                scale_r=args.scaleR, max_coarse=args.maxCoarse,
                mask_region_th=args.maskRegionTh,
                begin_index=args.beginIndex, end_index=args.endIndex,
                bg_mask_fn=sky, n_devices=n_devices, batch_pairs=args.batchPairs,
                adaptive_chunk=args.adaptiveChunk, anchor_stride=args.anchorStride,
                relax_cells=args.relaxCells,
            )
    else:
        scene = SCENES[args.scene]
        errors, accs = evaluate_yfcc(
            os.path.join(args.predDir, scene),
            os.path.join(args.testPair, f"{scene}-te-1000-pairs.pkl"),
            os.path.join(args.gtPath, scene, "test"),
            args.device, multi_h=args.multiH, th=args.th,
            use_ransac=args.ransac, threshold=args.threshold,
            min_size=args.minSize,
        )
        for k, v in accs.items():
            print(f"Scene {scene} {k}: {v:.4f}")
        with open(args.outRes, "w") as f:
            json.dump({scene: [float(e) for e in errors], "accs": accs}, f)


if __name__ == "__main__":
    main()
