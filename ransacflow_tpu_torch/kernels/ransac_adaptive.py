"""Kernel 4: adaptive RANSAC, chunks scored until the confidence bound is met
(`csrc/ransac_adaptive.cu`)."""

import ctypes

import torch

from ransacflow_tpu_torch.kernels.build import Kernel, check, forbid_grad, ptr, stream
from ransacflow_tpu_torch.kernels.ransac import ransac_score_ref

KERNEL = Kernel("rf_ransac_adaptive",
                [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
                + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                + [ctypes.c_void_p] * 6)
# state slots of the source
BEST_COUNT, BEST_SAMPLE, CHUNKS_RUN = 0, slice(1, 5), 6


def _chunk_done(best_count, n_valid, evaluated, n_iter, confidence):
    """The reference's stop test in fp32 (`ops/ransac.py:275-279`)."""
    f32 = torch.float32
    w = best_count.to(f32) / n_valid.clamp_min(1).to(f32)
    w4 = torch.clamp_max(w * w * (w * w), 1.0 - 1e-7)
    denom = torch.clamp_max(torch.log1p(-w4), -1e-30)
    n_req = torch.log1p(-torch.tensor(confidence, dtype=f32)) / denom
    return evaluated >= torch.clamp_max(n_req, float(n_iter))


def ransac_adaptive_ref(match1, match2, valid, samples, chunk, n_iter,
                        tolerance, confidence):
    """Plain PyTorch. samples: (n_chunks * chunk, 4) int32 match indices,
    scored a chunk at a time. Returns (best_H (3, 3), best_count () int32,
    best_sample (4,) int32, chunks_run () int32): the running best changes
    only on a strictly larger chunk maximum (first index on ties), and the
    loop stops once (chunks run) * chunk >= min(n_req, n_iter)."""
    n_valid = valid.sum(dtype=torch.int32)
    best_H = torch.eye(3, dtype=match1.dtype, device=match1.device)
    best_count = torch.zeros((), dtype=torch.int32, device=match1.device)
    best_sample = torch.zeros(4, dtype=torch.int32, device=match1.device)
    chunks_run = 0
    for c in range(samples.shape[0] // chunk):
        sets = samples[c * chunk:(c + 1) * chunk]
        H, counts = ransac_score_ref(match1, match2, valid, sets, tolerance)
        c_best = torch.argmax(counts)
        if counts[c_best] > best_count:
            best_count, best_H, best_sample = counts[c_best], H[c_best], sets[c_best]
        chunks_run += 1
        if _chunk_done(best_count, n_valid, chunks_run * chunk, n_iter, confidence):
            break
    return best_H, best_count, best_sample, torch.tensor(chunks_run, dtype=torch.int32)


def ransac_adaptive(match1, match2, valid, samples, chunk, n_iter, tolerance,
                    confidence):
    """`ransac_adaptive_ref` for CPU tensors, the kernel for CUDA ones, whose
    stop test stays on the device: every chunk is enqueued, a chunk after
    the stop returns at once, and nothing is read back. `samples` must lie
    in [0, N). Forward only: raises when a match array requires grad under
    grad mode."""
    forbid_grad("ransac_adaptive", match1, match2)
    if match1.device.type == "cpu":
        return ransac_adaptive_ref(match1, match2, valid, samples, chunk, n_iter,
                                   tolerance, confidence)
    n = match1.shape[0]
    dev = match1.device
    if chunk < 1 or samples.shape[0] % chunk:
        raise ValueError(f"samples: {samples.shape[0]} rows is not a multiple "
                         f"of chunk {chunk}")
    check(match1, "match1", torch.float32, shape=(n, 3))
    check(match2, "match2", torch.float32, shape=(n, 3), device=dev)
    check(valid, "valid", torch.bool, shape=(n,), device=dev)
    check(samples, "samples", torch.int32, shape=(samples.shape[0], 4), device=dev)
    n_valid = valid.sum(dtype=torch.int32)
    H = torch.empty((chunk, 9), dtype=torch.float32, device=dev)
    counts = torch.empty(chunk, dtype=torch.int32, device=dev)
    best_H = torch.eye(3, dtype=torch.float32, device=dev)
    state = torch.zeros(8, dtype=torch.int32, device=dev)
    KERNEL(dev, ptr(match1), ptr(match2), ptr(valid), n, ptr(samples),
           samples.shape[0] // chunk, chunk, n_iter, tolerance, confidence,
           ptr(n_valid), ptr(H), ptr(counts), ptr(best_H), ptr(state),
           stream(match1))
    return best_H, state[BEST_COUNT], state[BEST_SAMPLE], state[CHUNKS_RUN]
