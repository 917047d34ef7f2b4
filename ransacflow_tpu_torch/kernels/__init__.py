"""Hand-written kernels of the port (CUDA C++ and Triton) and their plain
versions.

Each wrapper takes its plain PyTorch version for CPU tensors and launches its
kernel for CUDA tensors; there is no other fallback. The CUDA library is
built from `ransacflow_tpu_torch/csrc/` at the first launch
(`kernels/build.py`); Triton compiles its kernels at their first launch.
"""

from ransacflow_tpu_torch.kernels import (
    compose,
    correlation,
    heads,
    matching,
    ransac,
    ransac_adaptive,
    warp_sample,
)

KERNELS = {
    "mutual_argmax": matching.KERNEL,           # K2
    "ransac_score": ransac.KERNEL,              # K3
    "ransac_adaptive": ransac_adaptive.KERNEL,  # K4
    "warp_sample": warp_sample.KERNEL,          # K5
    "correlation_volume": correlation.KERNEL,   # K6
    "head_epilogues": heads.KERNEL,             # K7
    "compose_tail": compose.KERNEL,             # K8
}


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts():
    for k in KERNELS.values():
        k.launches = 0
