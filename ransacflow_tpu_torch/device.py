"""The explicit device every entry point of the port takes, and its float32
policy."""

import contextlib

import torch


def as_device(device):
    """`device` (a str or torch.device) as a torch.device; raises when it
    names CUDA and no CUDA device is there. There is no default."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device} requested but CUDA is not available")
    return device


def use_full_fp32():
    """Float32 compute means float32 on the card, the reference's policy
    (`ransacflow_tpu/cli/common.py:90-99`): turn TF32 off for cuDNN's
    convolutions (PyTorch's default is on) and for CUDA matrix products.
    Global: for the command-line entry points."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def full_fp32():
    """`use_full_fp32` inside the block (or the decorated call) only; the
    caller's flags are restored after it. For library classes, which must
    not change a caller's global settings."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    use_full_fp32()
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
