"""Tensor ops of the port (see the package docstring), under the names the
JAX package's `ransacflow_tpu.ops` exports.

Images and feature maps are channels-last (B, H, W, C); normalized
coordinates are (x, y) in [-1, 1]; a homography H21 maps target points to
source points. Functions that create a tensor take its `device`. Where the
op is a hand-written kernel, the name is the kernel's wrapper
(`correlation_volume` kernel 6, `blur_pool` kernel 9 on NCHW with its
filter from `binomial_filter(channels, filt_size)`, `masked_ssim_loss`
kernel 10); RANSAC and matching run theirs inside.
"""

from ransacflow_tpu_torch.ops.grid import (  # noqa: F401
    feature_cell_coords,
    feature_cell_indices,
    normalized_grid,
)
from ransacflow_tpu_torch.ops.sampler import (  # noqa: F401
    affine_grid,
    grid_sample,
    interpolate_bilinear,
    upsample_bilinear_x8,
)
from ransacflow_tpu_torch.ops.homography import (  # noqa: F401
    apply_homography,
    dlt_homography,
    dlt_homography_np,
    fit_affine,
    fit_hough,
    fit_translation,
    reprojection_error,
    warp_grid,
)
from ransacflow_tpu_torch.ops.saliency import saliency_coef  # noqa: F401
from ransacflow_tpu_torch.ops.matching import mutual_matching  # noqa: F401
from ransacflow_tpu_torch.ops.ransac import (  # noqa: F401
    ransac_homography,
    ransac_homography_adaptive,
)
from ransacflow_tpu_torch.kernels.ransac import RansacResult  # noqa: F401
from ransacflow_tpu_torch.ops.blurpool import (  # noqa: F401
    binomial_filter,
    blur_pool,
    blur_pool_1d,
)
from ransacflow_tpu_torch.ops.correlation import corr_offset_grids  # noqa: F401
from ransacflow_tpu_torch.kernels.correlation import correlation_volume  # noqa: F401
from ransacflow_tpu_torch.ops.ssim import gaussian_window, masked_ssim_loss  # noqa: F401
