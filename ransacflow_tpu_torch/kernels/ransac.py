"""Kernel 3: RANSAC hypothesis solve and score (`csrc/ransac.cu`)."""

import ctypes

import torch

from ransacflow_tpu_torch.kernels.build import Kernel, check, forbid_grad, ptr, stream
from ransacflow_tpu_torch.ops.homography import dlt_homography

DET_EPS = 1e-6  # kDetEps in the source
KERNEL = Kernel("rf_ransac_score",
                [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_int, ctypes.c_float]
                + [ctypes.c_void_p] * 3)


def ransac_score_ref(match1, match2, valid, samples, tolerance):
    """Plain PyTorch. match1, match2 (N, 3); valid (N,) bool; samples
    (n_iter, 4) int32 match indices -> (H21 (n_iter, 3, 3), counts (n_iter,)
    int32), count 0 for a set with a repeated index or |det H| <= 1e-6."""
    n_points = samples.shape[1]
    idx = samples.long()
    unique = (idx[:, :, None] == idx[:, None, :]).sum(dim=(1, 2)) <= n_points
    H = dlt_homography(match1[idx], match2[idx])
    ok = unique & (torch.linalg.det(H).abs() > DET_EPS)
    ex = match2 @ H[:, 0, :].T  # (N, n_iter)
    ey = match2 @ H[:, 1, :].T
    ez = match2 @ H[:, 2, :].T
    du = ex / ez - match1[:, 0:1]
    dv = ey / ez - match1[:, 1:2]
    tol = torch.full((), tolerance, dtype=match1.dtype, device=match1.device)
    hit = (du * du + dv * dv < tol * tol) & valid[:, None]
    return H, hit.sum(dim=0).to(torch.int32) * ok


def ransac_score(match1, match2, valid, samples, tolerance):
    """`ransac_score_ref` for CPU tensors, the kernel for CUDA ones.
    `samples` must lie in [0, N). Forward only: raises when a match array
    requires grad under grad mode."""
    forbid_grad("ransac_score", match1, match2)
    if match1.device.type == "cpu":
        return ransac_score_ref(match1, match2, valid, samples, tolerance)
    n = match1.shape[0]
    n_iter = samples.shape[0]
    dev = match1.device
    check(match1, "match1", torch.float32, shape=(n, 3))
    check(match2, "match2", torch.float32, shape=(n, 3), device=dev)
    check(valid, "valid", torch.bool, shape=(n,), device=dev)
    check(samples, "samples", torch.int32, shape=(n_iter, 4), device=dev)
    H = torch.empty((n_iter, 3, 3), dtype=torch.float32, device=dev)
    counts = torch.empty(n_iter, dtype=torch.int32, device=dev)
    KERNEL(dev, ptr(match1), ptr(match2), ptr(valid), n, ptr(samples), n_iter,
           tolerance, ptr(H), ptr(counts), stream(match1))
    return H, counts
