"""The eval harnesses of the port (see `ransacflow_tpu/eval`): HPatches,
KITTI 2015, the sparse-correspondence harness and YFCC (with its cv2-free
pose estimator, `eval.pose`), the Aachen correspondence export, their
shared compose core and artifact schema, the sky-mask hooks and the pool of
slots that spreads their pairs (`eval.pooled`)."""

from ransacflow_tpu_torch.eval.aachen import export_correspondences, write_match_file  # noqa: F401

from ransacflow_tpu_torch.eval.artifacts import check_complete, load_pair, save_pair  # noqa: F401
from ransacflow_tpu_torch.eval.compose import (  # noqa: F401
    fill_flow_nearest,
    merge_multi_h,
    reconstruct_flows,
    remove_small_cc,
)
from ransacflow_tpu_torch.eval.corr import PIXEL_GRID, evaluate_corr, predict_corr  # noqa: F401
from ransacflow_tpu_torch.eval.hpatches import (  # noqa: F401
    evaluate_hpatches,
    hpatches_gt_grid,
    predict_hpatches,
)
from ransacflow_tpu_torch.eval.kitti import (  # noqa: F401
    evaluate_kitti,
    pooled_kitti_predict,
    predict_kitti,
    read_kitti_flow,
)
from ransacflow_tpu_torch.eval.pooled import (  # noqa: F401
    make_device_pool,
    pool_devices,
    pooled_multihomo_predict,
)
from ransacflow_tpu_torch.eval.pose import (  # noqa: F401
    eight_point_fundamental,
    find_essential_mat,
    five_point_essential,
    recover_pose,
)
from ransacflow_tpu_torch.eval.sky import (  # noqa: F401
    make_sky_bg_fn,
    make_sky_bg_fn_rotated,
    resize_mask,
)
from ransacflow_tpu_torch.eval.yfcc import (  # noqa: F401
    ANGLES,
    SCENES,
    estimate_pose,
    evaluate_yfcc,
    load_scene_calibration,
    matches_from_flow,
    norm_kp,
    pick_rotation,
    pooled_yfcc_predict,
    pose_error,
    predict_yfcc,
)
