"""Kernel 7 in Triton: the epilogues of the flow and matchability heads.

Replaces: ransacflow_tpu/models/heads.py:69-99, the softmax over the k*k
conv4 logits of each cell, its expectation against the correlation offsets
(`corr_offset_grids`: channel c is the offset (c % k - k//2, c // k - k//2))
scaled by 2 / W and 2 / H, and the matchability sigmoid.

What bounds it on the H100: at the fine stage's 60x80 cells it reads 940 KB
of logits and writes 38 KB: well under a microsecond of memory traffic, so
launch latency bounds it. One program handles a block of cells as a
(cells x 64) tile, 49 logits padded to 64 lanes with -inf, and reduces along
the row in registers; nothing between the logits and the flow touches
memory. The conv stack before it stays on cuDNN.

Imported only by the launching functions of `kernels/heads.py`: the CPU
hosts that run the tests have no Triton.
"""

import triton
import triton.language as tl


@triton.jit
def flow_epilogue_kernel(logits_ptr, out_ptr, n_cells, H, W,
                         K: tl.constexpr, KK: tl.constexpr, P: tl.constexpr,
                         BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
    cols = tl.arange(0, BLOCK_C)
    rmask = rows < n_cells
    cmask = cols < KK
    x = tl.load(logits_ptr + rows[:, None] * KK + cols[None, :],
                mask=rmask[:, None] & cmask[None, :], other=0.0)
    x = tl.where(cmask[None, :], x, float("-inf"))
    e = tl.exp(x - tl.max(x, axis=1)[:, None])
    p = e / tl.sum(e, axis=1)[:, None]
    gx = (cols % K - P).to(tl.float32)
    gy = (cols // K - P).to(tl.float32)
    fx = tl.sum(p * gx[None, :], axis=1) / W * 2.0
    fy = tl.sum(p * gy[None, :], axis=1) / H * 2.0
    tl.store(out_ptr + rows * 2, fx, mask=rmask)
    tl.store(out_ptr + rows * 2 + 1, fy, mask=rmask)


@triton.jit
def sigmoid_kernel(x_ptr, out_ptr, n, BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask, other=0.0)
    tl.store(out_ptr + offs, 1.0 / (1.0 + tl.exp(-x)), mask=mask)
