"""Hand-written kernels of the port (CUDA C++) and their plain versions.

Each wrapper takes its plain PyTorch version for CPU tensors and launches its
kernel for CUDA tensors; there is no other fallback. A wrapper on the
training path is a `torch.autograd.Function` whose backward is a kernel too
(counted under its own `_bwd` name); the others are forward only and raise
when an input requires grad under grad mode. The CUDA library is built from
`ransacflow_tpu_torch/csrc/` at the first launch (`kernels/build.py`).
"""

from ransacflow_tpu_torch.kernels import (
    adaptive_pool,
    anchor_resample,
    blurpool,
    compose,
    conv_epilogue,
    correlation,
    fine_conv,
    heads,
    matching,
    pyramid,
    ransac,
    ransac_adaptive,
    ssim,
    warp_sample,
)

KERNELS = {
    "lanczos_pyramid": pyramid.KERNEL,                 # K1
    "mutual_argmax": matching.KERNEL,                  # K2
    "ransac_score": ransac.KERNEL,                     # K3
    "ransac_adaptive": ransac_adaptive.KERNEL,         # K4
    "warp_sample": warp_sample.KERNEL,                 # K5, grid form
    "warp_homography": warp_sample.KERNEL_HOMOGRAPHY,  # K5, homography form
    "correlation_volume": correlation.KERNEL,          # K6
    "correlation_pair": correlation.KERNEL_PAIR,       # K6, both fine-stage volumes
    "correlation_volume_bwd": correlation.KERNEL_BWD,  # K6 backward
    "head_epilogues": heads.KERNEL,                    # K7
    "head_epilogues_bwd": heads.KERNEL_BWD,            # K7 backward
    "compose_tail": compose.KERNEL,                    # K8
    "blur_pool": blurpool.KERNEL,                      # K9
    "blur_pool_bwd": blurpool.KERNEL_BWD,              # K9 backward
    "masked_ssim": ssim.KERNEL,                        # K10
    "masked_ssim_bwd": ssim.KERNEL_BWD,                # K10 backward
    "grid_sample_bwd": warp_sample.KERNEL_BWD,         # K11
    "anchor_resample": anchor_resample.KERNEL,         # K12
    "ppm_pool": adaptive_pool.KERNEL,                  # K13
    "conv_epilogue": conv_epilogue.KERNEL,             # K14
    "fine_conv": fine_conv.KERNEL,                     # K15
}


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts():
    for k in KERNELS.values():
        k.launches = 0
