"""The serving path (`fused.fused_align`, `fused.fused_align_batch`), the
multi-homography loop (`CoarseAligner` with `multi_homography_predict` on
the host or `multi_homography_predict_fused` on the device), iterative
refinement of a flow (`refine_flow_ransac`) and the public two-image
aligner (`RansacFlowAligner`)."""

from ransacflow_tpu_torch.models.convert import init_alignment_params  # noqa: F401
from ransacflow_tpu_torch.pipeline.api import RansacFlowAligner  # noqa: F401
from ransacflow_tpu_torch.pipeline.coarse import CoarseAligner  # noqa: F401
from ransacflow_tpu_torch.pipeline.fine import fine_features, pred_flow_mask  # noqa: F401
from ransacflow_tpu_torch.pipeline.multihomo import (  # noqa: F401
    multi_homography_predict,
    multi_homography_predict_fused,
)
from ransacflow_tpu_torch.pipeline.refine import refine_flow_ransac  # noqa: F401
