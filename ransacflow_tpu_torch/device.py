"""The explicit device every entry point of the port takes."""

import torch


def as_device(device):
    """`device` (a str or torch.device) as a torch.device; raises when it
    names CUDA and no CUDA device is there. There is no default."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device} requested but CUDA is not available")
    return device
