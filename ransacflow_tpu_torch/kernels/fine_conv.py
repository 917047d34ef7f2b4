"""Kernel 15: a frozen convolution of the fine networks (the fine feature
extractor and the flow and matchability heads) as one fp32 implicit GEMM on
NHWC activations, with its epilogue: bias, the shortcut where there is one,
then ReLU (`csrc/fine_conv.cu`). The networks' eval-mode BatchNorm is
folded into the weights (`models/layers.FrozenBNFold`), which `pack_conv`
lays out once, at fold time, as the kernel reads them.

The launch goes through an autograd Function (`_FineConv`, forward only), so
that a profiler trace links the kernel's device time to a host event inside
the caller's spans.
"""

import ctypes
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ransacflow_tpu_torch.kernels.build import Kernel, forbid_grad, library, ptr, stream

KERNEL = Kernel("rf_fine_conv", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 14 + [ctypes.c_void_p])

BLOCK_M = 128
BLOCK_N = (128, 64)  # the kernel's two tile configs,
BLOCK_K = (32, 16)   # their k depth of a stage (`csrc/fine_conv.cu` `Tile`)
MAX_SPLITS = 8
MIN_SPLIT_K = 128  # k a split at the least
# the per-tile counters of split-K: 0 between launches (the last split of a
# tile sets its counter back), one buffer a device and stream
SEM_SIZE = 1 << 16

_LOCK = threading.Lock()
_plans = {}
_sems = {}
_occupancy = {}


class PackedConv(NamedTuple):
    """A convolution as kernel 15 reads it: `weight` (R * S * Cin, Npad),
    row k = (r * S + s) * Cin + c, Npad = Cout rounded up to 4 with zero
    columns; `bias` (Cout,) or None (then no epilogue at all)."""

    weight: torch.Tensor
    bias: object
    cin: int
    cout: int
    kernel_size: int
    stride: int
    padding: int


def pack_conv(weight, bias, stride, padding):
    """(Cout, Cin, R, R) fp32 weight and its (Cout,) bias or None ->
    `PackedConv`."""
    cout, cin, r, s = weight.shape
    if r != s:
        raise ValueError(f"pack_conv: square kernels only, got {r}x{s}")
    k = r * s * cin
    packed = weight.new_zeros((k, -(-cout // 4) * 4))
    packed[:, :cout] = weight.permute(2, 3, 1, 0).reshape(k, cout)
    return PackedConv(packed, None if bias is None else bias.contiguous(), cin, cout, r,
                      stride, padding)


def pack_folded(conv_module, w, b):
    """`pack_conv` of a folded convolution (`models/layers.fold_bn`'s w and
    b): the module's stride and padding, the bias rounded to fp32."""
    return pack_conv(w, None if b is None else b.float(), conv_module.stride[0],
                     conv_module.padding[0])


def unpacked_weight(pc):
    """The (Cout, Cin, R, R) weight of a `PackedConv` (a view)."""
    r = pc.kernel_size
    return pc.weight[:, :pc.cout].reshape(r, r, pc.cin, pc.cout).permute(3, 2, 0, 1)


def out_hw(pc, h, w):
    r, s, p = pc.kernel_size, pc.stride, pc.padding
    return (h + 2 * p - r) // s + 1, (w + 2 * p - r) // s + 1


def fine_conv_ref(x, pc, residual=None):
    """Plain PyTorch: (B, H, W, Cin) NHWC -> (B, Ho, Wo, Cout) NHWC, the
    convolution, then (with a bias) + bias, + residual (B, Ho, Wo, Cout),
    ReLU, in that order."""
    y = F.conv2d(x.permute(0, 3, 1, 2), unpacked_weight(pc), None, pc.stride, pc.padding)
    if pc.bias is not None:
        y = y + pc.bias.view(1, -1, 1, 1)
        if residual is not None:
            y = y + residual.permute(0, 3, 1, 2)
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1).contiguous()


def _cdiv(a, b):
    return -(-a // b)


def plan(m, n, k, sms, blocks_per_sm):
    """(tile config, its k tiles a split) for an M x N x K product on `sms` SMs,
    `blocks_per_sm` the blocks of each config an SM holds at once. From the
    shape alone: the config and split count whose busiest SM does the least
    work, an SM holding fewer than 8 warps taken to run below its rate, a
    split costing its partials' round trip."""
    best = None
    for cfg, bn in enumerate(BLOCK_N):
        if cfg == 0 and n <= BLOCK_N[1]:
            continue  # a 128-wide tile would be half empty
        kt = _cdiv(k, BLOCK_K[cfg])
        warps = BLOCK_M * bn // 2048
        tiles = _cdiv(m, BLOCK_M) * _cdiv(n, bn)
        for splits in range(1, MAX_SPLITS + 1):
            kps = _cdiv(kt, splits)
            if splits > 1 and (kps * BLOCK_K[cfg] < MIN_SPLIT_K
                               or tiles >= sms * blocks_per_sm[cfg]):
                break
            blocks = tiles * _cdiv(kt, kps)
            per_sm = _cdiv(blocks, sms)
            rate = min(1.0, warps * min(per_sm, blocks_per_sm[cfg]) / 8)
            cost = (per_sm * BLOCK_M * bn * (kps + 2) * BLOCK_K[cfg] / rate
                    * (1 + 0.03 * (splits - 1)))
            if cfg == 1:
                cost *= 1.05  # 1.5 times the operand traffic a FLOP of the wide tile
            if best is None or cost < best[0]:
                best = (cost, cfg, kps)
    return best[1], best[2]


def _device_plan(device, m, n, k):
    key = (device.index, m, n, k)
    got = _plans.get(key)
    if got is None:
        with _LOCK:
            if device.index not in _occupancy:
                query = library().rf_fine_conv_occupancy
                query.argtypes, query.restype = [ctypes.c_int], ctypes.c_int
                with torch.cuda.device(device):
                    occ = [query(cfg) for cfg in range(len(BLOCK_N))]
                if min(occ) <= 0:
                    raise RuntimeError(f"rf_fine_conv_occupancy: {occ}")
                sms = torch.cuda.get_device_properties(device).multi_processor_count
                _occupancy[device.index] = (sms, occ)
            sms, occ = _occupancy[device.index]
            got = _plans.setdefault(key, plan(m, n, k, sms, occ))
    return got


def _sem(device, raw_stream):
    key = (device.index, raw_stream)
    sem = _sems.get(key)
    if sem is None:
        with _LOCK:
            sem = _sems.setdefault(key, torch.zeros(SEM_SIZE, dtype=torch.int32, device=device))
    return sem


class _FineConv(torch.autograd.Function):
    """One launch of kernel 15 (forward only: the frozen networks run under
    no grad)."""

    @staticmethod
    def forward(ctx, x, residual, pc):
        weight, bias = pc.weight, pc.bias
        b, h, w, _ = x.shape
        ho, wo = out_hw(pc, h, w)
        y = torch.empty((b, ho, wo, pc.cout), dtype=x.dtype, device=x.device)
        m, kk = b * ho * wo, pc.kernel_size * pc.kernel_size * pc.cin
        cfg, kps = _device_plan(x.device, m, pc.cout, kk)
        raw = stream(x)
        splits = _cdiv(_cdiv(kk, BLOCK_K[cfg]), kps)
        ws = sem = None
        if splits > 1:
            tiles = _cdiv(m, BLOCK_M) * _cdiv(pc.cout, BLOCK_N[cfg])
            if tiles > SEM_SIZE:
                raise ValueError(f"fine_conv: {tiles} split tiles, more than {SEM_SIZE}")
            ws = torch.empty(tiles * splits * BLOCK_M * BLOCK_N[cfg], dtype=x.dtype,
                             device=x.device)
            sem = _sem(x.device, raw)
        KERNEL(x.device, ptr(x), ptr(weight), 0 if bias is None else ptr(bias),
               0 if residual is None else ptr(residual), ptr(y),
               0 if ws is None else ptr(ws), 0 if sem is None else ptr(sem),
               b, h, w, pc.cin, ho, wo, pc.cout, weight.shape[1], pc.kernel_size,
               pc.kernel_size, pc.stride, pc.padding, cfg, kps, raw)
        return y

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("fine_conv has no backward")


def fine_conv(x, pc, residual=None):
    """`fine_conv_ref` for a CPU tensor. For a CUDA one, one launch of the
    kernel. On either: `x` contiguous (B, H, W, Cin) fp32, `residual`
    contiguous (B, Ho, Wo, Cout) fp32 (only with a bias), the packed weight
    and the bias fp32 on x's device; raises on anything else. Forward only.
    Returns a new NHWC tensor."""
    forbid_grad("fine_conv", x, residual)
    if not (x.dtype == torch.float32 and x.dim() == 4 and x.shape[3] == pc.cin
            and x.is_contiguous() and x.numel() > 0):
        raise ValueError(f"fine_conv: x must be contiguous NHWC fp32 with {pc.cin} channels; "
                         f"got {x.dtype} {tuple(x.shape)} {x.stride()}")
    if x.shape[0] * x.shape[1] * x.shape[2] >= 2**31:
        raise ValueError(f"fine_conv: {tuple(x.shape)}: the kernel indexes pixels in 32 bits")
    if not (pc.weight.dtype == torch.float32 and pc.weight.device == x.device
            and pc.weight.is_contiguous()
            and (pc.bias is None or (pc.bias.dtype == torch.float32
                                     and pc.bias.device == x.device))):
        raise ValueError("fine_conv: the packed weight and bias must be fp32 on x's device")
    if residual is not None:
        want = (x.shape[0], *out_hw(pc, x.shape[1], x.shape[2]), pc.cout)
        if pc.bias is None or not (tuple(residual.shape) == want and residual.is_contiguous()
                                   and residual.dtype == torch.float32
                                   and residual.device == x.device):
            raise ValueError(f"fine_conv: residual must be contiguous fp32 {want} on x's "
                             "device, with a bias")
    if x.device.type == "cpu":
        return fine_conv_ref(x, pc, residual)
    return _FineConv.apply(x, residual, pc)
