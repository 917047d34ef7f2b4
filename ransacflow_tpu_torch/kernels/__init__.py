"""Hand-written CUDA kernels of the serving path and their plain versions.

Each wrapper takes its plain PyTorch version for CPU tensors and launches its
kernel for CUDA tensors; there is no other fallback. The library is built
from `ransacflow_tpu_torch/csrc/` at the first launch (`kernels/build.py`).
"""

from ransacflow_tpu_torch.kernels import correlation, matching, ransac

KERNELS = {
    "correlation_volume": correlation.KERNEL,
    "mutual_argmax": matching.KERNEL,
    "ransac_score": ransac.KERNEL,
}


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts():
    for k in KERNELS.values():
        k.launches = 0
