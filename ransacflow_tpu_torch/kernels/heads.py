"""Kernel 7: the epilogues of the flow and matchability heads and their
backward (`csrc/heads.cu`)."""

import ctypes

import torch

from ransacflow_tpu_torch.kernels.build import (
    Kernel,
    check,
    forbid_grad,
    ptr,
    stream,
    upcast,
)
from ransacflow_tpu_torch.ops.correlation import corr_offset_grids

# every forward launch counts here: a fine pass's three epilogues, or one
# training epilogue
KERNEL = Kernel("rf_head_epilogues",
                [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# both backward kernels count here
KERNEL_BWD = Kernel("rf_head_epilogues_bwd",
                    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
MAX_OFFSETS = 64  # the k*k logits of a cell: the kernel is built for k <= 8


def flow_epilogue_ref(logits, kernel_size=7):
    """Plain PyTorch. (B, H, W, k*k) conv4 logits -> (B, H, W, 2) flow:
    the softmax expectation over the k x k offset grid (x then y), divided by
    the width / height, times 2."""
    p = torch.softmax(logits, dim=-1)
    gx, gy = corr_offset_grids(kernel_size, p.device, p.dtype)
    _, h, w, _ = p.shape
    return torch.stack([(p * gx).sum(-1) / w * 2.0,
                        (p * gy).sum(-1) / h * 2.0], dim=-1)


def match_epilogue_ref(logits):
    """Plain PyTorch: the matchability sigmoid."""
    return torch.sigmoid(logits)


def head_epilogues_ref(flow_logits, match12_logits, match21_logits, kernel_size=7):
    """Plain PyTorch: a fine pass's three epilogues. flow_logits: (B, H, W,
    k*k); match12_logits, match21_logits: (B, H, W, 1). Returns (flow_down8
    (B, H, W, 2), match12_down8, match21_down8 (B, H, W, 1), match_down8
    (B, H, W, 2), the two sigmoids side by side)."""
    m12, m21 = match_epilogue_ref(match12_logits), match_epilogue_ref(match21_logits)
    return (flow_epilogue_ref(flow_logits, kernel_size), m12, m21,
            torch.cat([m12, m21], dim=-1))


def _check_flow_logits(logits, kernel_size):
    check(logits, "logits", torch.float32, ndim=4)
    kk = kernel_size * kernel_size
    if logits.shape[-1] != kk:
        raise ValueError(f"logits: {logits.shape[-1]} channels, expected {kk}")
    if kk > MAX_OFFSETS:
        raise ValueError(f"kernel_size {kernel_size}: k*k must be <= {MAX_OFFSETS}")


def head_epilogues(flow_logits, match12_logits, match21_logits, kernel_size=7):
    """`head_epilogues_ref` for CPU tensors, one kernel launch for CUDA ones.
    Forward only: raises when an input requires grad under grad mode. bf16
    logits (the eval policy) are upcast, and each output is rounded to its
    logits' dtype, the reference's."""
    forbid_grad("head_epilogues", flow_logits, match12_logits, match21_logits)
    dtypes = (flow_logits.dtype, match12_logits.dtype, match21_logits.dtype,
              torch.promote_types(match12_logits.dtype, match21_logits.dtype))
    flow_logits, match12_logits, match21_logits = upcast(flow_logits, match12_logits,
                                                         match21_logits)
    if flow_logits.device.type == "cpu":
        outs = head_epilogues_ref(flow_logits, match12_logits, match21_logits, kernel_size)
        return tuple(o.to(d) for o, d in zip(outs, dtypes))
    dev = flow_logits.device
    _check_flow_logits(flow_logits, kernel_size)
    b, h, w, _ = flow_logits.shape
    check(match12_logits, "match12_logits", torch.float32, shape=(b, h, w, 1), device=dev)
    check(match21_logits, "match21_logits", torch.float32, shape=(b, h, w, 1), device=dev)
    flow = torch.empty((b, h, w, 2), dtype=torch.float32, device=dev)
    m12, m21 = torch.empty_like(match12_logits), torch.empty_like(match21_logits)
    match = torch.empty((b, h, w, 2), dtype=torch.float32, device=dev)
    KERNEL(dev, ptr(flow_logits), ptr(match12_logits), ptr(match21_logits), ptr(flow),
           ptr(m12), ptr(m21), ptr(match), b * h * w, kernel_size, h, w,
           stream(flow_logits))
    return tuple(o.to(d) for o, d in zip((flow, m12, m21, match), dtypes))


class _FlowEpilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, kernel_size):
        _check_flow_logits(logits, kernel_size)
        b, h, w, _ = logits.shape
        out = torch.empty((b, h, w, 2), dtype=torch.float32, device=logits.device)
        KERNEL(logits.device, ptr(logits), None, None, ptr(out), None, None, None,
               b * h * w, kernel_size, h, w, stream(logits))
        ctx.save_for_backward(logits)
        ctx.kernel_size = kernel_size
        return out

    @staticmethod
    def backward(ctx, g):
        (logits,) = ctx.saved_tensors
        b, h, w, _ = logits.shape
        g = g.contiguous()
        d = torch.empty_like(logits)
        KERNEL_BWD(logits.device, ptr(logits), ptr(g), ptr(d), None, None, None,
                   b * h * w, ctx.kernel_size, h, w, stream(logits))
        return d, None


class _MatchEpilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits):
        check(logits, "logits", torch.float32)
        out = torch.empty_like(logits)
        KERNEL(logits.device, None, ptr(logits), None, None, ptr(out), None, None,
               logits.numel(), 0, 1, 1, stream(logits))
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        g = g.contiguous()
        d = torch.empty_like(s)
        KERNEL_BWD(s.device, None, None, None, ptr(s), ptr(g), ptr(d), s.numel(), 0, 1, 1,
                   stream(s))
        return d


def flow_epilogue(logits, kernel_size=7):
    """`flow_epilogue_ref` for a CPU tensor, the kernel for a CUDA one,
    differentiable: its backward is a kernel too. The training path's flow
    head; the alignment paths take `head_epilogues`. bf16 logits (both
    policies) are upcast and the flow rounded to bf16; their cotangent
    comes back in bf16."""
    dtype = logits.dtype
    (logits,) = upcast(logits)
    if logits.device.type == "cpu":
        return flow_epilogue_ref(logits, kernel_size).to(dtype)
    return _FlowEpilogue.apply(logits, kernel_size).to(dtype)


def match_epilogue(logits):
    """`match_epilogue_ref` for a CPU tensor, the kernel for a CUDA one,
    differentiable: its backward is a kernel too. The training path's
    matchability head. bf16 as `flow_epilogue`."""
    dtype = logits.dtype
    (logits,) = upcast(logits)
    if logits.device.type == "cpu":
        return match_epilogue_ref(logits).to(dtype)
    return _MatchEpilogue.apply(logits).to(dtype)
