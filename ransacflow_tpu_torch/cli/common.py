"""Shared CLI plumbing: weight loading, coarse-net selection and the sky
mask (the port's copy of `ransacflow_tpu/cli/common.py`: importing the JAX
package imports JAX). Every loader takes the device."""

import torch

from ransacflow_tpu_torch.models.convert import (
    init_alignment_params,
    init_resnet50_layer3,
    load_alignment_checkpoint,
    load_resnet50_trunk,
    load_segnet,
)
from ransacflow_tpu_torch.train.checkpoint import load_checkpoint


def load_align_params(resume_path, device, kernel_size=7):
    """Alignment networks from a reference .pth, a port checkpoint
    (`train.checkpoint.save_checkpoint`), or seeded."""
    if not resume_path:
        print("WARNING: no --resumePth given, using random-init nets")
        return init_alignment_params(torch.Generator().manual_seed(0), device, kernel_size)
    if resume_path.endswith(".pth"):
        return load_alignment_checkpoint(resume_path, device, kernel_size)
    nets = init_alignment_params(torch.Generator().manual_seed(0), device, kernel_size)
    load_checkpoint(resume_path, nets)
    return nets


def load_coarse_net(device, moco_path=None, imagenet_path=None):
    """The coarse ResNet-50 trunk: the MoCo checkpoint, a torchvision
    state_dict, or seeded with a warning (no download here)."""
    if moco_path:
        return load_resnet50_trunk(moco_path, device, moco=True)
    if imagenet_path:
        return load_resnet50_trunk(imagenet_path, device)
    print("WARNING: no coarse-feature weights given, using random init")
    return init_resnet50_layer3(torch.Generator().manual_seed(0), device)


def add_model_args(parser):
    parser.add_argument("--resumePth", type=str, default=None,
                        help="alignment checkpoint (.pth or a port .pt)")
    parser.add_argument("--kernelSize", type=int, default=7)
    parser.add_argument("--mocoPth", type=str, default=None,
                        help="MoCo ResNet-50 .pth for coarse features")
    parser.add_argument("--imageNetPth", type=str, default=None,
                        help="torchvision ResNet-50 state_dict .pth")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the torch device to run on")


def add_segnet_args(parser):
    parser.add_argument("--segNet", action="store_true",
                        help="remove sky with the segmentation net")
    parser.add_argument("--segEncoderPth", type=str, default=None)
    parser.add_argument("--segDecoderPth", type=str, default=None)


def build_sky_fn(args, device, rotated=False):
    """The `--segNet` hook: fn(img_path, (Ht, Wt)[, angle]) -> bg_mask, or
    None without --segNet."""
    if not getattr(args, "segNet", False):
        return None
    from ransacflow_tpu_torch.eval.sky import make_sky_bg_fn, make_sky_bg_fn_rotated
    from ransacflow_tpu_torch.models.segnet import SkySegmenter

    enc, dec = load_segnet(args.segEncoderPth, args.segDecoderPth, device)
    seg = SkySegmenter(enc, dec, device, seg_id=2, seg_fg=False)
    return make_sky_bg_fn_rotated(seg) if rotated else make_sky_bg_fn(seg)


def add_adaptive_flag(parser):
    parser.add_argument(
        "--adaptiveChunk", type=int, default=0,
        help="confidence-based RANSAC early exit: evaluate hypotheses in "
             "blocks of this size and stop once the 0.999-confidence bound "
             "is met; --coarseIter becomes a cap. 0 = fixed iteration count "
             "(reference-parity default)")
    parser.add_argument(
        "--anchorStride", type=int, default=0,
        help="anchor-stride feature pyramid (opt-in approximation): run the "
             "coarse trunk only at every k-th pyramid scale and bilinearly "
             "resample the rest from the nearest anchor. 0 = exact per-scale "
             "trunk (reference-parity default)")
    parser.add_argument(
        "--relaxCells", type=int, default=0,
        help="relaxed mutual-match reciprocity (opt-in companion to "
             "--anchorStride): accept a match when the back-match lands "
             "within this many target feature cells. 0 = reference semantics "
             "(parity default)")
