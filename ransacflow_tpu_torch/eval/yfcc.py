"""YFCC two-view geometry harness, camera pose by the essential matrix (port
of `ransacflow_tpu/eval/yfcc.py`).

Prediction mirrors evaluation/evalYFCC/evaluation.py:176-296: a 4-rotation
pre-test picks the target orientation with the most RANSAC inliers, then the
multi-homography loop runs on the chosen rotation with the masked target
re-matched against the bank on every call (min side 480, 7 scales, 10k
hypotheses, cycle matching); the winning angle is stored with the artifact.
The metric pass mirrors getResults.py:53-190: the composed flow (kernel 8)
gives pixel matches with the target grid rotated back, the intrinsics
normalize them, and `eval.pose` (in place of OpenCV) estimates the
essential matrix and recovers the pose; Acc@5/10/15/20 of the max(rotation,
translation) angular error and their mean (mAP).
"""

import os
import pickle

import numpy as np
import torch
from PIL import Image

from ransacflow_tpu_torch.device import as_device
from ransacflow_tpu_torch.eval.artifacts import load_pair, save_pair
from ransacflow_tpu_torch.eval.compose import merge_multi_h, reconstruct_flows
from ransacflow_tpu_torch.eval.pose import (
    eight_point_fundamental,
    find_essential_mat,
    recover_pose,
)
from ransacflow_tpu_torch.eval.pooled import (
    BatchedMultiHomoDispatcher,
    PendingDrain,
    make_device_pool,
    pool_devices,
)
from ransacflow_tpu_torch.pipeline.coarse import CoarseAligner
from ransacflow_tpu_torch.pipeline.multihomo import (
    multi_homography_dispatch,
    multi_homography_predict,
)
from ransacflow_tpu_torch.utils.image import min_size_shape_wh

ANGLES = (0, 90, 180, 270)
SCENES = (
    "notre_dame_front_facade",
    "buckingham_palace",
    "reichstag",
    "sacre_coeur",
)


def pick_rotation(coarse, img_t, bg_mask_fn=None, dispatch=False):
    """Try the target at 0/90/180/270 deg; keep the rotation with the most
    inliers (reference: evaluation/evalYFCC/evaluation.py:190-209; the
    foreground mask takes part in each rotation's coarse fit).

    coarse: a CoarseAligner with set_source() done.
    bg_mask_fn: optional callable(angle, (Ht, Wt)) -> foreground mask for the
      rotated, resized target.
    dispatch: run the four fits with `CoarseAligner.dispatch_inlier_count`
      and read their counts back once, stacked (the device-resident loop's
      pre-test); else one `get_coarse` each, as the host loop does.
    Returns (angle, rotated PIL image, chosen index).
    """
    rotated = [img_t if a == 0 else img_t.rotate(a, expand=True) for a in ANGLES]
    counts = []
    for j, img in enumerate(rotated):
        coarse.set_target(img)
        mask = None
        if bg_mask_fn is not None:
            mask = 1.0 - bg_mask_fn(ANGLES[j], coarse.tgt_array.shape[:2])
        if dispatch:
            counts.append(coarse.dispatch_inlier_count(mask))
        else:
            H, inlier = coarse.get_coarse(mask)
            counts.append(0.0 if H is None else float(inlier.sum()))
    if dispatch:
        counts = torch.stack(counts).cpu().numpy()
    best = int(np.argmax(counts))
    return ANGLES[best], rotated[best], best


def predict_yfcc(
    pairs_pkl,
    image_dir,
    out_dir,
    resnet,
    align_params,
    device,
    min_size=480,
    nb_scale=7,
    n_iter=10000,
    tolerance=0.05,
    scale_r=2.0,
    max_coarse=10,
    mask_region_th=0.01,
    begin_index=0,
    end_index=1000,
    bg_mask_fn=None,
    n_devices=None,
    batch_pairs=None,
    adaptive_chunk=0,
    anchor_stride=0,
    relax_cells=0,
):
    """Run prediction for one scene on `device`.

    Args:
      pairs_pkl: the scene's '<scene>-te-1000-pairs.pkl' (a list of [idxA,
        idxB] into images.txt, data/YFCC/pairs).
      image_dir: '<root>/<scene>/test', holding images.txt.
      resnet, align_params: the coarse trunk and the alignment networks on
        `device`.
      bg_mask_fn: optional callable(img_path, (Ht, Wt), angle) -> foreground
        mask (the segNet hook, `eval.sky.make_sky_bg_fn_rotated`).
      n_devices: None runs the rotation pre-test and the host loop
        (`multi_homography_predict`, the fp64 polish of each winner);
        otherwise `pooled_yfcc_predict` over a pool of slots
        (`eval.pooled.pool_devices`), with batch_pairs.
    """
    coarse_kwargs = dict(
        nb_scale=nb_scale, n_iter=n_iter, tolerance=tolerance, min_size=min_size,
        scale_r=scale_r, resize_mode="min",
        # the quick-start matching variant: the masked target is re-matched
        # against the bank on every coarse call, so excluded regions free
        # their source cells (evalYFCC/coarseAlignFeatMatch.py:163-169)
        rematch_per_call=True, adaptive_chunk=adaptive_chunk,
        anchor_stride=anchor_stride, relax_cells=relax_cells,
    )
    loop_kw = dict(max_coarse=max_coarse, mask_region_th=mask_region_th,
                   begin_index=begin_index, end_index=end_index, bg_mask_fn=bg_mask_fn)
    if n_devices is not None:
        pooled_yfcc_predict(pairs_pkl, image_dir, out_dir, resnet, align_params,
                            pool_devices(n_devices, device), coarse_kwargs,
                            batch_pairs=batch_pairs, **loop_kw)
        return
    coarse = CoarseAligner(resnet, device, **coarse_kwargs)
    for i, i_s, tgt_path in _scene_pairs(pairs_pkl, image_dir, begin_index, end_index):
        coarse.set_source(i_s)
        angle, rotated, _ = pick_rotation(coarse, Image.open(tgt_path).convert("RGB"),
                                          _rotation_mask_fn(bg_mask_fn, tgt_path))
        coarse.set_target(rotated)
        bg = None
        if bg_mask_fn is not None:
            bg = bg_mask_fn(tgt_path, coarse.tgt_array.shape[:2], angle)
        pred = multi_homography_predict(coarse, align_params, max_coarse=max_coarse,
                                        mask_region_th=mask_region_th, cycle_match=True,
                                        bg_mask=bg)
        if pred is not None:
            save_pair(out_dir, i, pred, rotation=np.int32(angle))


def _scene_pairs(pairs_pkl, image_dir, begin_index, end_index):
    """(pair index, source PIL, target path) of the scene's pairs in
    [begin_index, end_index)."""
    with open(pairs_pkl, "rb") as f:
        pairs = pickle.load(f)
    with open(os.path.join(image_dir, "images.txt")) as f:
        img_list = [line.strip() for line in f if line.strip()]
    for i in range(begin_index, min(end_index, len(pairs))):
        id_a, id_b = pairs[i]
        yield (i, Image.open(os.path.join(image_dir, img_list[id_a])).convert("RGB"),
               os.path.join(image_dir, img_list[id_b]))


def _rotation_mask_fn(bg_mask_fn, tgt_path):
    """`pick_rotation`'s mask callable(angle, (Ht, Wt)), or None."""
    if bg_mask_fn is None:
        return None
    return lambda a, hw: bg_mask_fn(tgt_path, hw, a)


def pooled_yfcc_predict(pairs_pkl, image_dir, out_dir, resnet, align_params, devices,
                        coarse_kwargs, max_coarse=10, mask_region_th=0.01,
                        begin_index=0, end_index=1000, bg_mask_fn=None, batch_pairs=None):
    """`predict_yfcc` over a pool of slots (`eval.pooled`): the pairs go
    round robin over the slots (with batch_pairs > 1, by shape bucket); each
    pair's rotation pre-test is dispatched (`pick_rotation(dispatch=True)`:
    the four fits' counts read back once) and its loop is the
    device-resident one, drained through the bounded queue.

    devices: the slots' devices (`eval.pooled.pool_devices`);
    coarse_kwargs: `CoarseAligner`'s. Pair i's pre-test and loop draw from
    `reseed(i)`'s generator, so the artifacts, the stored rotation
    included, are the same for any pool and batching.
    """
    pool = make_device_pool(resnet, align_params, devices, coarse_kwargs)
    drain = PendingDrain(len(pool), lambda idx, art, angle: save_pair(
        out_dir, idx, art, rotation=np.int32(angle)))
    loop_kw = dict(max_coarse=max_coarse, mask_region_th=mask_region_th, cycle_match=True)
    batcher = None
    if batch_pairs and batch_pairs > 1:
        batcher = BatchedMultiHomoDispatcher(pool, drain, batch_pairs, **loop_kw)
    pairs = _scene_pairs(pairs_pkl, image_dir, begin_index, end_index)
    for k, (i, i_s, tgt_path) in enumerate(pairs):
        i_t = Image.open(tgt_path).convert("RGB")
        if batcher is not None:
            # the proxy key fixes the slot before the pre-test; 0/180 and
            # 90/270 winners then land in other shape buckets of one slot
            proxy = (i_s.size, i_t.size)
            aligner, nets = pool[batcher.slot(proxy)]
        else:
            aligner, nets = pool[k % len(pool)]
        aligner.set_source(i_s)
        aligner.reseed(i)
        angle, rotated, _ = pick_rotation(aligner, i_t, _rotation_mask_fn(bg_mask_fn,
                                                                          tgt_path),
                                          dispatch=True)
        aligner.set_target(rotated)
        bg = None
        if bg_mask_fn is not None:
            bg = bg_mask_fn(tgt_path, aligner.tgt_array.shape[:2], angle)
        if batcher is not None:
            batcher.add(proxy, i, bg, aligner.generator, angle)
            continue
        final, bgf = multi_homography_dispatch(aligner, nets, bg_mask=bg, **loop_kw)
        drain.add(i, final, bgf, angle)
    if batcher is not None:
        batcher.flush()
    else:
        drain.flush()


def matches_from_flow(flow, match_binary, size_a, size_b, angle):
    """Dense flow -> pixel correspondence lists (getResults.py:53-71).

    The target grid is rotated back by `angle` so pts2 are in the original
    (unrotated) target frame.
    """
    w_a, h_a = size_a
    w_b, h_b = size_b
    gx, gy = np.meshgrid(np.arange(w_b), np.arange(h_b))
    grid_b = np.rot90(np.stack([gx, gy], axis=2), angle // 90)
    pts2 = grid_b[match_binary]
    pts1 = flow[match_binary].copy()
    pts1[:, 0] = (pts1[:, 0] + 1) * (w_a - 1) / 2
    pts1[:, 1] = (pts1[:, 1] + 1) * (h_a - 1) / 2
    return pts1, pts2


def norm_kp(org_size, new_size, K, kp):
    """Pixel coords -> normalized image-plane coords (getResults.py:29-50)."""
    w, h = org_size
    w_n, h_n = new_size
    cx = (w - 1.0) * 0.5 + K[0, 2]
    cy = (h - 1.0) * 0.5 + K[1, 2]
    fx, fy = K[0, 0], K[1, 1]
    cx *= w_n / w
    cy *= h_n / h
    fx *= w_n / w
    fy *= h_n / h
    return (kp - np.array([[cx, cy]])) / np.array([[fx, fy]])


def pose_error(R_gt, t_gt, R_pred, t_pred):
    """Angular errors of rotation and translation (getResults.py:114-129)."""
    t_gt = t_gt.flatten() / np.linalg.norm(t_gt)
    t_pred = t_pred.flatten() / np.linalg.norm(t_pred)
    R = R_gt @ R_pred.T
    err_q = np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)) * 180 / np.pi
    err_t = np.arccos(np.clip(t_gt @ t_pred, -1, 1)) * 180 / np.pi
    return err_q, err_t


def estimate_pose(pts1, pts2, use_ransac=True, threshold=0.0005, seed=0, *, device):
    """Essential-matrix estimation and pose recovery (getResults.py:75-111)
    by `eval.pose`, in place of cv2.findEssentialMat (or findFundamentalMat
    with FM_8POINT) and cv2.recoverPose.

    seed: the RANSAC draws' numpy seed; device: where its hypotheses are
    scored and the points triangulated. Returns (R, t) or None: with fewer
    than 5 points, without a model, or when no stacked solution has a point
    in front of both cameras. Never raises on degenerate input."""
    if pts1.shape[0] < 5:
        return None
    if use_ransac:
        E, mask = find_essential_mat(pts1, pts2, threshold, seed=seed, device=device)
    else:
        E, mask = eight_point_fundamental(pts1, pts2)
    if E is None or not np.isfinite(E).all():
        return None
    best = None
    best_inl = 0
    for e in np.split(E, len(E) // 3):
        n_inl, R, t = recover_pose(e, pts1, pts2, mask, device=device)
        if n_inl > best_inl:
            best_inl = n_inl
            best = (R, t)
    return best


def load_scene_calibration(scene_path, min_size=480):
    """Per-image R, t, K, original and resized sizes from the YFCC
    calibration .h5 files (needs h5py, imported here)."""
    import h5py

    with open(os.path.join(scene_path, "images.txt")) as f:
        images = [line.strip() for line in f if line.strip()]
    with open(os.path.join(scene_path, "calibration.txt")) as f:
        calibs = [line.strip() for line in f if line.strip()]
    out = []
    for im, calib in zip(images, calibs):
        with h5py.File(os.path.join(scene_path, calib), "r") as h5:
            out.append({
                "R": np.array(h5["R"]),
                "t": np.array(h5["T"]).T,
                "K": np.array(h5["K"]),
                "org_size": np.array(h5["imsize"][0]).tolist(),
                "resized": min_size_shape_wh(
                    Image.open(os.path.join(scene_path, im)).size, min_size),
            })
    return out


@torch.inference_mode()
def evaluate_yfcc(
    pred_dir,
    pairs_pkl,
    scene_path,
    device,
    multi_h=True,
    th=0.95,
    use_ransac=True,
    threshold=0.0005,
    min_size=480,
    seed=0,
    calibration=None,
):
    """Per-pair max(R, t) angular errors and Acc@{5,10,15,20}, the flows
    composed on `device`, where the pose RANSAC also scores its hypotheses.

    seed: pair i's RANSAC draws come from numpy's default_rng((seed, i)).
    calibration: the records of `load_scene_calibration(scene_path,
      min_size)`, or None to read them (h5py).
    Returns (errors list, {acc5, acc10, acc15, acc20, mAP}).
    """
    device = as_device(device)
    with open(pairs_pkl, "rb") as f:
        pairs = pickle.load(f)
    calib = load_scene_calibration(scene_path, min_size) if calibration is None else calibration

    errors = []
    for i, (id_a, id_b) in enumerate(pairs):
        art = load_pair(pred_dir, i)
        if art is None:
            errors.append(180.0)
            continue
        h8, w8 = art["fine_flow_down8"].shape[1:3]
        flows, matches = reconstruct_flows(
            art["coarse_h"], art["fine_flow_down8"], art["fine_match_down8"],
            h8 * 8, w8 * 8, device, cycle_match=True,
        )
        merged = merge_multi_h(flows, matches, th, multi_h)
        match_binary = merged["match_binary"] & art["bg_mask"].astype(bool)

        pts1, pts2 = matches_from_flow(
            merged["flow"], match_binary,
            calib[id_a]["resized"], calib[id_b]["resized"],
            int(art.get("rotation", 0)),
        )
        if len(pts1) == 0:
            errors.append(180.0)
            continue
        n1 = norm_kp(calib[id_a]["org_size"], calib[id_a]["resized"], calib[id_a]["K"], pts1)
        n2 = norm_kp(calib[id_b]["org_size"], calib[id_b]["resized"], calib[id_b]["K"],
                     pts2.astype(np.float64))
        pose = estimate_pose(n1, n2, use_ransac, threshold, seed=(seed, i), device=device)
        if pose is None:
            errors.append(180.0)
            continue
        R_gt = calib[id_b]["R"] @ calib[id_a]["R"].T
        t_gt = calib[id_b]["t"] - R_gt @ calib[id_a]["t"]
        errors.append(max(pose_error(R_gt, t_gt, pose[0], pose[1])))

    err = np.array(errors)
    accs = {f"acc{t}": float((err < t).mean()) for t in (5, 10, 15, 20)}
    accs["mAP"] = float(np.mean([accs[f"acc{t}"] for t in (5, 10, 15, 20)]))
    return errors, accs
