"""KITTI 2015 optical-flow harness CLI (port of
`ransacflow_tpu/cli/eval_kitti.py`).

  python -m ransacflow_tpu_torch.cli.eval_kitti predict --testImg training/image_2 \
      --outDir pred/ [--device cuda]
  python -m ransacflow_tpu_torch.cli.eval_kitti results --predDir pred/ \
      --gtPath training/flow_noc --multiH --interpolate [--device cuda]
"""

import argparse

from ransacflow_tpu_torch.cli.common import (
    add_adaptive_flag,
    add_compute_dtype_flag,
    add_model_args,
    add_segnet_args,
    build_sky_fn,
    cast_for_dtype,
    load_align_params,
    load_coarse_net,
)
from ransacflow_tpu_torch.device import use_full_fp32
from ransacflow_tpu_torch.eval.kitti import evaluate_kitti, pooled_kitti_predict, predict_kitti
from ransacflow_tpu_torch.eval.pooled import pool_devices


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("predict")
    add_model_args(p)
    add_segnet_args(p)
    add_adaptive_flag(p)
    add_compute_dtype_flag(p)
    p.add_argument("--testImg", type=str, required=True)
    p.add_argument("--outDir", type=str, required=True)
    p.add_argument("--coarseIter", type=int, default=50000)
    p.add_argument("--maskRegionTh", type=float, default=0.005)
    p.add_argument("--coarsetolerance", type=float, default=0.05)
    p.add_argument("--nbScale", type=int, default=3)
    p.add_argument("--scaleR", type=float, default=1.2)
    p.add_argument("--coarseSize", type=int, default=800)
    p.add_argument("--fineSize", type=int, default=650)
    p.add_argument("--cc_th", type=float, default=0.01)
    p.add_argument("--beginIndex", type=int, default=0)
    p.add_argument("--endIndex", type=int, default=200)
    p.add_argument("--nDevices", type=int, default=None,
                   help="a pool of this many slots, one a card (cuda:0 ... "
                        "cuda:n-1, raises when the machine has fewer), each "
                        "pair on its slot's sequential loop (the accept "
                        "decision runs the host's connected-component "
                        "cleanup). Default: one device")

    r = sub.add_parser("results")
    r.add_argument("--predDir", type=str, required=True)
    r.add_argument("--gtPath", type=str, required=True)
    r.add_argument("--multiH", action="store_true")
    r.add_argument("--th", type=float, default=1.0)
    r.add_argument("--cc_th", type=float, default=0.01)
    r.add_argument("--interpolate", action="store_true")
    r.add_argument("--onlyCoarse", action="store_true")
    r.add_argument("--nPairs", type=int, default=200)
    r.add_argument("--device", type=str, default="cuda",
                   help="the torch device the flows are composed on")

    args = parser.parse_args(argv)
    devices = None
    if args.cmd == "predict" and args.nDevices is not None:
        devices = pool_devices(args.nDevices, args.device)
    use_full_fp32()

    if args.cmd == "predict":
        kw = dict(
            coarse_size=args.coarseSize, fine_size=args.fineSize,
            nb_scale=args.nbScale, scale_r=args.scaleR,
            n_iter=args.coarseIter, tolerance=args.coarsetolerance,
            mask_region_th=args.maskRegionTh, cc_th=args.cc_th,
            begin_index=args.beginIndex, end_index=args.endIndex,
            bg_mask_fn=build_sky_fn(args, args.device),
            adaptive_chunk=args.adaptiveChunk,
            anchor_stride=args.anchorStride,
            relax_cells=args.relaxCells,
        )
        resnet = cast_for_dtype(load_coarse_net(args.device, args.mocoPth, args.imageNetPth),
                                args.computeDtype)
        align = cast_for_dtype(load_align_params(args.resumePth, args.device, args.kernelSize),
                               args.computeDtype)
        if devices is None:
            predict_kitti(args.testImg, args.outDir, resnet, align, args.device, **kw)
        else:
            pooled_kitti_predict(args.testImg, args.outDir, resnet, align, devices, **kw)
    else:
        mean_epe, _ = evaluate_kitti(
            args.predDir, args.gtPath, args.device, n_pairs=args.nPairs,
            multi_h=args.multiH, th=args.th, cc_th=args.cc_th,
            interpolate=args.interpolate, only_coarse=args.onlyCoarse,
        )
        print(f"Average end-point error (EPE): {mean_epe:.4f}")


if __name__ == "__main__":
    main()
