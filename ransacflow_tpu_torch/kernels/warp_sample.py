"""Kernel 5, bilinear sampling (`csrc/warp_sample.cu`), and its backward,
kernel 11 (`csrc/grid_sample_bwd.cu`).

K5 has two forms: `warp_homography`, the fine stage's source warp, which
evaluates the homography's grid in the kernel and writes the warped image and
that grid in one launch; and `warp_sample` at a given grid, the training
losses' differentiable `grid_sample` (K11 its backward, also callable bare as
`grid_sample_backward`).
"""

import ctypes

import torch

from ransacflow_tpu_torch.kernels.build import Kernel, check, forbid_grad, ptr, stream
from ransacflow_tpu_torch.ops.homography import warp_grid
from ransacflow_tpu_torch.ops.sampler import grid_sample

KERNEL = Kernel("rf_warp_sample",
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
KERNEL_HOMOGRAPHY = Kernel("rf_warp_homography",
                           [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
KERNEL_BWD = Kernel("rf_grid_sample_bwd",
                    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
_axes = {}         # (h, w, device) -> the torch.linspace(-1, 1) axes of a warp grid
_tile_counts = {}  # device -> K11's (2,) int64 counts of shared and global tiles


def warp_sample_ref(image, grid):
    """Plain PyTorch: `F.grid_sample(align_corners=True, padding_mode=
    'zeros')` of (B, H, W, C) `image` at (B, Ho, Wo, 2) normalized (x, y)
    `grid`, with its own autograd. Returns (B, Ho, Wo, C)."""
    return grid_sample(image, grid)


def warp_homography_ref(src, H, out_hw):
    """Plain PyTorch: `warp_grid(H, *out_hw)` then `warp_sample_ref`.
    Returns (warped (B, Ho, Wo, C), grid (B, Ho, Wo, 2))."""
    grid = warp_grid(H, *out_hw)
    return warp_sample_ref(src, grid), grid


def grid_sample_backward_ref(image, grid, g, need_image):
    """Plain PyTorch: the cotangents of `warp_sample_ref(image, grid)` for
    the output cotangent `g`, by autograd. Returns (d_image or None when
    not `need_image`, d_grid)."""
    with torch.enable_grad():
        img = image.detach().requires_grad_(need_image)
        grd = grid.detach().requires_grad_()
        grads = torch.autograd.grad(warp_sample_ref(img, grd),
                                    [img, grd] if need_image else [grd], g)
    return (grads[0], grads[1]) if need_image else (None, grads[0])


def _check_image(image, name):
    check(image, name, torch.float32, ndim=4)
    b, h, w, c = image.shape
    if c not in (1, 2, 3) or b >= 65536:
        raise ValueError(f"{name}: shape {tuple(image.shape)}: the kernel takes "
                         "1-3 channels and fewer than 65536 images")
    return b, h, w, c


def _check_grid(grid, b, device):
    check(grid, "grid", torch.float32, ndim=4, device=device)
    if grid.shape[0] != b or grid.shape[3] != 2:
        raise ValueError(f"grid: shape {tuple(grid.shape)}, expected ({b}, Ho, Wo, 2)")
    if grid.data_ptr() % 8:
        raise ValueError("grid: must be 8-byte aligned (read as float2)")
    return grid.shape[1], grid.shape[2]


def _below_2_31(*numels):
    if max(numels) >= 2**31:
        raise ValueError("warp_sample: tensors must hold fewer than 2^31 elements")


def _warp(image, grid):
    """Kernel 5, grid form: one launch, no autograd."""
    b, h, w, c = _check_image(image, "image")
    ho, wo = _check_grid(grid, b, image.device)
    _below_2_31(image.numel(), grid.numel(), b * ho * wo * c)
    out = torch.empty((b, ho, wo, c), dtype=torch.float32, device=image.device)
    KERNEL(image.device, ptr(image), ptr(grid), ptr(out), b, h, w, c, ho, wo,
           stream(image))
    return out


def tile_counts(device):
    """K11's counts, since the last `reset_tile_counts`, of the splatting
    tiles that took the shared-memory path (or touched no pixel) and of
    those that took the global path: a (2,) int64 tensor on `device`."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _tile_counts.get(device, torch.zeros(2, dtype=torch.int64, device=device))


def reset_tile_counts():
    _tile_counts.clear()


def grid_sample_backward(image, grid, g, need_image):
    """The cotangents of `warp_sample(image, grid)` for the output cotangent
    `g`: (d_image, or None when not `need_image`, d_grid). For CUDA tensors
    kernel 11 in one launch (after the zeroing of d_image), for CPU ones
    `grid_sample_backward_ref`."""
    if image.device.type == "cpu":
        return grid_sample_backward_ref(image, grid, g, need_image)
    b, h, w, c = _check_image(image, "image")
    ho, wo = _check_grid(grid, b, image.device)
    check(g, "g", torch.float32, shape=(b, ho, wo, c), device=image.device)
    _below_2_31(image.numel(), grid.numel(), g.numel())
    dev = image.device
    d_image = torch.zeros_like(image) if need_image else None
    d_grid = torch.empty_like(grid)
    tiles = _tile_counts.get(dev)
    if tiles is None:
        with torch.inference_mode(False):
            tiles = _tile_counts[dev] = torch.zeros(2, dtype=torch.int64, device=dev)
    KERNEL_BWD(dev, ptr(image), ptr(grid), ptr(g),
               None if d_image is None else ptr(d_image), ptr(d_grid), ptr(tiles),
               b, h, w, c, ho, wo, stream(image))
    return d_image, d_grid


class _WarpSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, image, grid):
        ctx.save_for_backward(image, grid)
        return _warp(image, grid)

    @staticmethod
    def backward(ctx, g):
        image, grid = ctx.saved_tensors
        d_image, d_grid = grid_sample_backward(image, grid, g.contiguous(),
                                               ctx.needs_input_grad[0])
        return d_image, (d_grid if ctx.needs_input_grad[1] else None)


def warp_sample(image, grid):
    """`warp_sample_ref` for CPU tensors. For CUDA ones, kernel 5, grid form,
    differentiable in both inputs (the backward is kernel 11); with grad
    mode off or no input requiring grad it launches with no autograd node."""
    if image.device.type == "cpu":
        return warp_sample_ref(image, grid)
    if torch.is_grad_enabled() and (image.requires_grad or grid.requires_grad):
        return _WarpSample.apply(image, grid)
    return _warp(image, grid)


def _linspace_axes(h, w, device):
    """The x (w,) and y (h,) `torch.linspace(-1, 1)` axes of a warp grid,
    built once per size and device and kept there."""
    key = (h, w, device)
    if key not in _axes:
        with torch.inference_mode(False):
            _axes[key] = (torch.linspace(-1.0, 1.0, w, device=device),
                          torch.linspace(-1.0, 1.0, h, device=device))
    return _axes[key]


def warp_homography(src, H, out_hw):
    """The fine stage's source warp: (B, Hs, Ws, C) `src` sampled on
    `warp_grid(H, *out_hw)` for (B, 3, 3) homographies `H` (dst -> src).
    Returns (warped (B, Ho, Wo, C), grid (B, Ho, Wo, 2)).

    `warp_homography_ref` for CPU tensors. For CUDA ones, kernel 5 in its
    homography form: the grid is evaluated in the kernel (H is read on the
    device, nothing comes back to the host) and written beside the image in
    one launch. Forward only: raises when an input requires grad under grad
    mode."""
    forbid_grad("warp_homography", src, H)
    if src.device.type == "cpu":
        return warp_homography_ref(src, H, out_hw)
    b, hs, ws, c = _check_image(src, "src")
    dev = src.device
    check(H, "H", torch.float32, shape=(b, 3, 3), device=dev)
    ho, wo = out_hw
    _below_2_31(src.numel(), b * ho * wo * max(c, 2))
    out = torch.empty((b, ho, wo, c), dtype=torch.float32, device=dev)
    grid = torch.empty((b, ho, wo, 2), dtype=torch.float32, device=dev)
    xs, ys = _linspace_axes(ho, wo, dev)
    KERNEL_HOMOGRAPHY(dev, ptr(src), ptr(H), ptr(xs), ptr(ys), ptr(out), ptr(grid),
                      b, hs, ws, c, ho, wo, stream(src))
    return out, grid
