"""The least time the card could take for each hand kernel's work on a
cell's path: each input byte read once and each output byte written once
at HBM's rate, or the operations at the fp32 peak, whichever is larger (the
rule of the kernel table in PERF.md). Keyed by the launch counter's name
(`ransacflow_tpu_torch.kernels.launch_counts`) and by what the launch
computes, so that the work reads the same whatever implements it.

`align_bounds(...)` and `train_bounds(...)` return {launch name: seconds a
launch}; `DEVICE_SYMBOLS` names the device kernels each launch runs, by
which the trace's device time is summed.
"""

import re

from portbench.counts.flops import HBM_BYTES_PER_S, PEAK_FLOPS

F32 = 4
# per (hypothesis, valid match): the projection (9 multiply-adds), the two
# divides, the squared residual, the test and count; per hypothesis the
# draws, the normalization and the closed-form 4-point solve
RANSAC_OPS_PER_MATCH, RANSAC_OPS_PER_SOLVE = 24, 350
# per pixel and channel: five Gaussian-blurred maps, two 11-tap passes
# each (a multiply and an add a tap); per pixel the 11x11 box of the mask
SSIM_OPS_PER_PIXEL_CHANNEL, SSIM_BOX_OPS_PER_PIXEL = 5 * 2 * 11 * 2, 2 * 11 * 2
# the backward: three partial maps a channel blurred (two passes, 11 taps)
SSIM_BWD_OPS_PER_PIXEL_CHANNEL = 3 * 2 * 11 * 2

DEVICE_SYMBOLS = (
    "pyramid_kernel", "chunk_kernel", "merge_kernel", "ransac_fit_kernel", "order_kernel",
    "ransac_adaptive_kernel", "warp_sample_kernel", "correlation_kernel",
    "correlation_bwd_kernel", "epilogue_kernel", "epilogue_bwd_kernel", "compose_kernel",
    "blurpool_fwd_kernel", "blurpool_bwd_kernel", "ssim_fwd_kernel", "ssim_reduce_kernel",
    "ssim_bwd_kernel", "grid_sample_bwd_kernel", "anchor_bank_kernel", "ppm_cells_kernel",
    "ppm_bins_kernel")
_SYMBOL = re.compile(r"(^|[^A-Za-z0-9_])(" + "|".join(DEVICE_SYMBOLS) + r")([^A-Za-z0-9_]|$)")


def is_hand_kernel(device_name):
    return _SYMBOL.search(device_name) is not None


def bound_s(n_bytes, n_ops=0):
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_FLOPS["float32"])


def _n(*shape):
    out = 1
    for s in shape:
        out *= s
    return out


def blur_out(h, w):
    """Reflect pad 1, 3 taps, stride 2."""
    return (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1


def blur_shapes(h, w):
    """(C, H, W) in and (H, W) out of the fine feature extractor's three
    blur-pools on an h x w image: the stem's after conv1 and a 2x2 max-pool
    of stride 1, then the downsample shortcuts of layer2 and layer3."""
    hs, ws = blur_out(h - 1, w - 1)
    h2, w2 = blur_out(hs, ws)
    h3, w3 = blur_out(h2, w2)
    return [((64, h - 1, w - 1), (hs, ws)), ((64, hs, ws), (h2, w2)),
            ((128, h2, w2), (h3, w3))]


def blur_bound(n, h, w):
    """Seconds of a blur-pool launch, averaged over a pass's three; the
    backward moves the same bytes (the cotangent in, the gradient out)."""
    total = 0.0
    for (c, hi, wi), (ho, wo) in blur_shapes(h, w):
        total += bound_s(F32 * n * c * (hi * wi + ho * wo))
    return total / 3


def align_bounds(k, src_hw, shapes, target_hw, n_hyp, n_valid, kernel_size=7,
                 stride=16):
    """Per launch on the serving path with k pairs a call (one launch of
    each batch form a call; the fine features' blur-pools six a call):
    n_valid the valid matches a pair (RANSAC's work depends on it)."""
    ht, wt = target_hw
    h8, w8 = ht // 8, wt // 8
    kk = kernel_size * kernel_size
    n_a = sum((h // stride) * (w // stride) for h, w in shapes)
    n_b = (ht // stride) * (wt // stride)
    mid = shapes[len(shapes) // 2]
    resized = sum(h * w for h, w in shapes if (h, w) != tuple(src_hw))
    return {
        "lanczos_pyramid": bound_s(F32 * k * 3 * (_n(*src_hw) + resized)),
        "mutual_argmax": bound_s(F32 * k * (n_a * n_b + n_a + 2 * n_b) + k * n_b),
        "ransac_score": bound_s(F32 * k * 7 * n_b,
                                k * n_hyp * (RANSAC_OPS_PER_SOLVE + RANSAC_OPS_PER_MATCH * n_valid)),
        "warp_homography": bound_s(F32 * k * (3 * _n(*mid) + 9 + 5 * ht * wt)),
        "correlation_pair": bound_s(F32 * k * h8 * w8 * (2 * 256 + 2 * kk)),
        "head_epilogues": bound_s(F32 * k * h8 * w8 * (kk + 2 + 2 + 1 + 1 + 2)),
        "compose_tail": bound_s(F32 * k * (h8 * w8 * 4 + 2 * ht * wt + 3 * ht * wt)),
        "blur_pool": blur_bound(k, ht, wt),
    }


def train_bounds(pairs, img, kernel_size=7):
    """Per launch of a training step of `pairs` pairs of img^2 images (2 *
    pairs images through every kernel). K7 and K7 backward, K5 and K11 and
    K9 launch several times a step at different widths: their bound is the
    mean of a step's launches."""
    n = 2 * pairs
    h8 = img // 8
    kk = kernel_size * kernel_size
    px = n * img * img
    cells = n * h8 * h8
    warp = [bound_s(F32 * px * (c + 2 + c)) for c in (1, 2, 3)]
    # backward: the cotangent, the image and the grid in; the image's
    # gradient (not for the images, C = 3, which are data) and the grid's out
    warp_bwd = [bound_s(F32 * px * (c + c + 2 + (c if c != 3 else 0) + 2)) for c in (1, 2, 3)]
    return {
        "blur_pool": blur_bound(n, img, img),
        "blur_pool_bwd": blur_bound(n, img, img),
        "correlation_volume": bound_s(F32 * cells * (2 * 256 + kk)),
        "correlation_volume_bwd": bound_s(F32 * cells * (kk + 2 * 256 + 2 * 256)),
        "head_epilogues": (bound_s(F32 * cells * (kk + 2)) + bound_s(F32 * cells * 2)) / 2,
        "head_epilogues_bwd": (bound_s(F32 * cells * (2 + kk + kk))
                               + bound_s(F32 * cells * 3)) / 2,
        "masked_ssim": bound_s(F32 * px * 7, px * (3 * SSIM_OPS_PER_PIXEL_CHANNEL
                                                   + SSIM_BOX_OPS_PER_PIXEL)),
        "masked_ssim_bwd": bound_s(F32 * px * (7 + 3), px * 3 * SSIM_BWD_OPS_PER_PIXEL_CHANNEL),
        "warp_sample": sum(warp) / 3,
        "grid_sample_bwd": sum(warp_bwd) / 3,
    }
