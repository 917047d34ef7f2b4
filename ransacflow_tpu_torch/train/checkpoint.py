"""Checkpoints of the alignment networks and the optimizer (the port's
counterpart of `ransacflow_tpu/train/checkpoint.py`): one `torch.save` file
(`.pt`) holding each network's `state_dict`, the optimizer's and the step.
A reference `.pth` warm start goes through
`models.convert.load_alignment_checkpoint`."""

import os

import torch

from ransacflow_tpu_torch.models.convert import load_alignment_checkpoint


def save_checkpoint(path, nets, opt=None, step=None):
    payload = {"nets": {name: net.state_dict() for name, net in nets.items()}}
    if opt is not None:
        payload["opt"] = opt.state_dict()
    if step is not None:
        payload["step"] = step
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(payload, path)


def load_checkpoint(path, nets=None, opt=None):
    """Load a `save_checkpoint` file; copy it into `nets` and `opt` when
    given. Returns the saved dict (tensors on the CPU)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for name, net in (nets or {}).items():
        net.load_state_dict(ckpt["nets"][name])
    if opt is not None and "opt" in ckpt:
        opt.load_state_dict(ckpt["opt"])
    return ckpt


def resume_params(path, nets, kernel_size=7):
    """Warm start: copy a checkpoint's networks into `nets`, keeping the
    initial weights of a network whose shapes do not fit. Takes the
    reference's released `.pth` files and `save_checkpoint` files (`.pt`)."""
    if path.endswith(".pth"):
        loaded = {name: net.state_dict() for name, net in
                  load_alignment_checkpoint(path, "cpu", kernel_size).items()}
    else:
        loaded = load_checkpoint(path)["nets"]
    for name, net in nets.items():
        if name not in loaded:
            continue
        try:
            net.load_state_dict(loaded[name])
        except RuntimeError:
            print(f"{name} weights not compatible, keeping init")
    return nets
