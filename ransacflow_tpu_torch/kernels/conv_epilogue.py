"""Kernel 14: the epilogue of a frozen trunk convolution, in place on its
NCHW output: bias, the shortcut where there is one, then ReLU
(`csrc/conv_epilogue.cu`). The trunk's eval-mode BatchNorm is folded into
the convolutions (`models/resnet50`), so this one pass is all that follows
each of them."""

import ctypes

import torch

from ransacflow_tpu_torch.kernels.build import Kernel, forbid_grad, ptr, stream

KERNEL = Kernel("rf_conv_epilogue",
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def conv_epilogue_ref(x, bias, residual=None):
    """Plain PyTorch, in place on (N, C, H, W) `x`: x + bias[c], plus
    `residual`, then ReLU, in that order. Returns `x`."""
    x.add_(bias.view(1, -1, 1, 1))
    if residual is not None:
        x.add_(residual)
    return x.relu_()


def conv_epilogue(x, bias, residual=None):
    """`conv_epilogue_ref` for a CPU tensor. For a CUDA one, one launch of
    the kernel, in place on `x` (contiguous NCHW fp32, as cuDNN returns a
    convolution of a contiguous input); `bias` (C,) fp32 and `residual`
    (x's shape, contiguous) on x's device. Forward only. Returns `x`.

    The launch path is kept lean (the trunk launches it 40 times a pass):
    no tensor is built and no device property read."""
    forbid_grad("conv_epilogue", x)
    if x.device.type == "cpu":
        return conv_epilogue_ref(x, bias, residual)
    n, c, h, w = x.shape
    if not (x.dtype == torch.float32 and x.is_contiguous() and bias.dtype == torch.float32
            and bias.shape == (c,) and bias.device == x.device):
        raise ValueError(f"conv_epilogue: x must be contiguous NCHW fp32 and bias ({c},) "
                         f"fp32 on its device; got x {x.dtype} {tuple(x.shape)} "
                         f"{x.stride()}, bias {bias.dtype} {tuple(bias.shape)} {bias.device}")
    if residual is not None and not (residual.shape == x.shape and residual.is_contiguous()
                                     and residual.dtype == torch.float32
                                     and residual.device == x.device):
        raise ValueError("conv_epilogue: residual must be contiguous fp32 of x's shape "
                         "on its device")
    KERNEL(x.device, ptr(x), ptr(bias), 0 if residual is None else ptr(residual),
           n * c, c, h * w, stream(x))
    return x
