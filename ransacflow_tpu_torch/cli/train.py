"""Training CLI (port of `ransacflow_tpu/cli/train.py`).

Usage:
  python -m ransacflow_tpu_torch.cli.train --trainImgDir data/train \
      --outDir runs/s3 --stage 3 --device cuda NoVal --epochSaveModel 1

  python -m ransacflow_tpu_torch.cli.train --trainImgDir data/train \
      --outDir runs/s3 --stage 3 --device cuda --nativeResize valMegaDepth \
      --valImgDir data/val --valCSV val.csv --inPklCoarse coarse.pkl

`--stage {1,2,3}` applies the reference's stage1/2/3.sh presets; explicit
flags override. valMegaDepth validates every epoch and keeps the best model
by prec@8 (`BestModel@8_{prec}`); NoVal checkpoints every --epochSaveModel
epochs. --nativeResize resizes the training crops with the native Lanczos
resampler (built with g++; it raises without one). --computeDtype bfloat16
trains under the mixed-precision policy (bf16 convolutions from fp32
masters) and --remat recomputes the feature trunk in the backward.

Data parallelism, one process a device, --batchSize the GLOBAL batch, rank 0
alone writing metrics.jsonl and the checkpoints (`train.loop.fit`):

  # N ranks spawned on cuda:0 ... cuda:N-1 (NCCL), or on the CPU (gloo)
  python -m ransacflow_tpu_torch.cli.train --nDevices 4 --stage 3 ... NoVal
  python -m ransacflow_tpu_torch.cli.train --nDevices 2 --device cpu ... NoVal

  # one process a card launched by torchrun; --nDevices is WORLD_SIZE
  python -m torch.distributed.run --nproc_per_node 4 \
      -m ransacflow_tpu_torch.cli.train --distributed --nDevices 4 ... NoVal
"""

import argparse

import torch
import torch.distributed as dist

from ransacflow_tpu_torch.device import use_full_fp32
from ransacflow_tpu_torch.models.convert import init_alignment_params
from ransacflow_tpu_torch.parallel import init_from_env, make_mesh, spawn
from ransacflow_tpu_torch.train.checkpoint import resume_params
from ransacflow_tpu_torch.train.loop import STAGES, fit


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--nEpochs", type=int, default=None)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--trainImgDir", type=str, required=True)
    parser.add_argument("--kernelSize", type=int, default=7)
    parser.add_argument("--imgSize", type=int, default=224)
    parser.add_argument("--batchSize", type=int, default=16)
    parser.add_argument("--outDir", type=str, required=True)
    parser.add_argument("--resumePth", type=str, default=None)
    parser.add_argument("--lambda-match", type=float, default=0.01, dest="lambda_match")
    parser.add_argument("--mu-cycle", type=float, default=None, dest="mu_cycle")
    parser.add_argument("--grad", type=float, default=None)
    parser.add_argument("--trainMode", choices=["flow", "flow+match", "grad"],
                        default=None)
    parser.add_argument("--margin", type=int, default=88)
    parser.add_argument("--stage", type=int, choices=[1, 2, 3], default=None,
                        help="curriculum preset (stage1/2/3.sh)")
    parser.add_argument("--nDevices", type=int, default=1,
                        help="data-parallel ranks (the GLOBAL count under --distributed)")
    parser.add_argument("--distributed", action="store_true",
                        help="join the process group of a torchrun launch")
    parser.add_argument("--computeDtype", choices=["float32", "bfloat16"],
                        default="float32")
    parser.add_argument("--nativeResize", action="store_true")
    parser.add_argument("--remat", action="store_true",
                        help="recompute the feature trunk in the backward")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--maxStepsPerEpoch", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="the torch device to train on")

    sub = parser.add_subparsers(title="validation choice", dest="subcommand")
    val = sub.add_parser("valMegaDepth")
    val.add_argument("--valImgDir", type=str, required=True)
    val.add_argument("--valCSV", type=str, required=True)
    val.add_argument("--inPklCoarse", type=str, required=True)
    val.add_argument("--valMinSize", type=int, default=480)
    noval = sub.add_parser("NoVal")
    noval.add_argument("--epochSaveModel", type=int, default=10)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    kind = torch.device(args.device).type
    if args.distributed:
        _, _, device = init_from_env(kind)
        try:
            train(args, device)
        finally:
            dist.destroy_process_group()
    elif args.nDevices > 1:
        devices = make_mesh(args.nDevices) if kind == "cuda" else [args.device] * args.nDevices
        spawn(_rank_train, devices, "nccl" if kind == "cuda" else "gloo", args=(args,),
              timeout=None)
    else:
        train(args, args.device)


def _rank_train(rank, world, device, args):
    train(args, device)


def train(args, device):
    """Train on `device` as the parsed `args` say (one rank of a group when
    --nDevices > 1)."""
    use_full_fp32()  # float32 stays float32 (BatchNorm, the losses, the masters)

    cfg = dict(mode="flow", mu_cycle=0.0, lambda_match=0.01, grad_weight=0.0,
               epochs=150)
    if args.stage is not None:
        cfg.update(STAGES[args.stage])
    if args.trainMode is not None:
        cfg["mode"] = args.trainMode
    if args.mu_cycle is not None:
        cfg["mu_cycle"] = args.mu_cycle
    if args.grad is not None:
        cfg["grad_weight"] = args.grad
    if args.nEpochs is not None:
        cfg["epochs"] = args.nEpochs
    cfg["lambda_match"] = args.lambda_match
    if "match" not in cfg["mode"]:
        cfg["lambda_match"] = 0.0
        print("trainMode without matchability: lambda_match forced to 0")

    nets = init_alignment_params(torch.Generator().manual_seed(args.seed), device,
                                 args.kernelSize)
    if args.resumePth:
        resume_params(args.resumePth, nets, args.kernelSize)
    val = {}
    if args.subcommand == "valMegaDepth":
        val = dict(val_csv=args.valCSV, val_dir=args.valImgDir,
                   val_coarse_pkl=args.inPklCoarse, val_min_size=args.valMinSize)
    fit(nets, args.trainImgDir, args.outDir, device,
        mode=cfg["mode"], mu_cycle=cfg["mu_cycle"], lambda_match=cfg["lambda_match"],
        grad_weight=cfg["grad_weight"], epochs=cfg["epochs"],
        batch_size=args.batchSize, img_size=args.imgSize, margin=args.margin,
        lr=args.lr, kernel_size=args.kernelSize,
        epoch_save_model=getattr(args, "epochSaveModel", 10), seed=args.seed,
        max_steps_per_epoch=args.maxStepsPerEpoch, use_native=args.nativeResize,
        n_devices=args.nDevices,
        compute_dtype=None if args.computeDtype == "float32" else args.computeDtype,
        remat=args.remat, **val)


if __name__ == "__main__":
    main()
