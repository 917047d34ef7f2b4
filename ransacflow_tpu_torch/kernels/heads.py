"""Kernel 7: epilogues of the flow and matchability heads (Triton,
`kernels/heads_triton.py`)."""

from types import SimpleNamespace

import torch

from ransacflow_tpu_torch.kernels.build import check
from ransacflow_tpu_torch.ops.correlation import corr_offset_grids

KERNEL = SimpleNamespace(launches=0)  # both epilogues count here
BLOCK_CELLS = 64    # cells per program of the flow epilogue
BLOCK_OFFSETS = 64  # lanes for the k*k logits of a cell, k*k <= 64
BLOCK_ELEMS = 1024


def _cdiv(a, b):
    return -(-a // b)


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


def flow_epilogue(logits, kernel_size=7):
    """`flow_epilogue_ref` for a CPU tensor, the Triton kernel for a CUDA
    one."""
    if logits.device.type == "cpu":
        return flow_epilogue_ref(logits, kernel_size)
    from ransacflow_tpu_torch.kernels import heads_triton

    kk = kernel_size * kernel_size
    check(logits, "logits", torch.float32, ndim=4)
    b, h, w, c = logits.shape
    if c != kk:
        raise ValueError(f"logits: {c} channels, expected {kk}")
    if kk > BLOCK_OFFSETS:
        raise ValueError(f"kernel_size {kernel_size}: k*k must be <= {BLOCK_OFFSETS}")
    out = torch.empty((b, h, w, 2), dtype=torch.float32, device=logits.device)
    n_cells = b * h * w
    with torch.cuda.device(logits.device):
        heads_triton.flow_epilogue_kernel[(_cdiv(n_cells, BLOCK_CELLS),)](
            logits, out, n_cells, h, w, K=kernel_size, KK=kk, P=kernel_size // 2,
            BLOCK_M=BLOCK_CELLS, BLOCK_C=BLOCK_OFFSETS, num_warps=4)
    KERNEL.launches += 1
    return out


def match_epilogue(logits):
    """`match_epilogue_ref` for a CPU tensor, the Triton kernel for a CUDA
    one."""
    if logits.device.type == "cpu":
        return match_epilogue_ref(logits)
    from ransacflow_tpu_torch.kernels import heads_triton

    check(logits, "logits", torch.float32)
    out = torch.empty_like(logits)
    n = logits.numel()
    with torch.cuda.device(logits.device):
        heads_triton.sigmoid_kernel[(_cdiv(n, BLOCK_ELEMS),)](
            logits, out, n, BLOCK=BLOCK_ELEMS, num_warps=4)
    KERNEL.launches += 1
    return out
