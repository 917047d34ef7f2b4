"""Parity of the port's YFCC harness, Aachen export and dataset CLIs with
the JAX package, on the CPU, at the JAX tests' 160-px sizes.

The RANSAC draws differ between the packages (the port's Philox against
threefry, and the pose RANSAC's numpy Generator against OpenCV's RNG), so
the predict passes are held to JAX at JAX's homographies (`_replay`), the
results pass by the points each package hands to its pose estimator and by
the pose errors, and the dataset CLIs by what they keep and write.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from ransacflow_tpu_torch.cli import eval_yfcc, generate_pairs, resize_dataset
from ransacflow_tpu_torch.eval import aachen, artifacts, yfcc
from ransacflow_tpu_torch.kernels import warp_sample
from ransacflow_tpu_torch.pipeline import CoarseAligner
from test_torch_eval import (
    DX_PX,
    DY_PX,
    H_IMG,
    W_IMG,
    YFCC_FOCAL,
    _blocky,
    _fg_border_mask,
    _near_threshold_keys,
    _record_pose_inputs,
    _same_points,
    _translation_pair,
    _yfcc_setup,
)
from test_torch_eval_predict import ATOL_MAPS, N_ITER, _replay, nets  # noqa: F401

POSE_DEG = 1.0    # the pose tolerance of tests/test_torch_pose.py


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's YFCC and Aachen modules (they import the eval
    package, which imports pandas)."""
    from ransacflow_tpu.eval import aachen as j_aachen
    from ransacflow_tpu.eval import yfcc as j_yfcc
    from ransacflow_tpu.pipeline import CoarseAligner as JCoarseAligner

    return j_yfcc, j_aachen, JCoarseAligner


def _bg(path, hw, angle):
    return _fg_border_mask(*hw)


def _rotated_scene(tmp_path, rng):
    """The translation pair with its target turned by 90 degrees, as a YFCC
    scene directory with one pair; the pre-test must turn it back (270)."""
    src, tgt = _translation_pair(rng)
    scene = tmp_path / "imgs" / "reichstag" / "test"
    os.makedirs(scene)
    src.save(scene / "im0.png")
    tgt.rotate(90, expand=True).save(scene / "im1.png")
    (scene / "images.txt").write_text("im0.png\nim1.png\n")
    os.makedirs(tmp_path / "pairs")
    pkl = tmp_path / "pairs" / "reichstag-te-1000-pairs.pkl"
    with open(pkl, "wb") as f:
        pickle.dump([[0, 1]], f)
    return str(pkl), str(scene)


PREDICT_KW = dict(min_size=H_IMG, nb_scale=1, n_iter=N_ITER, max_coarse=1, end_index=1,
                  bg_mask_fn=_bg)


def test_predict_yfcc_matches_jax(tmp_path, rng, nets, jx, monkeypatch):
    """Both packages' pre-tests pick 270 for a target turned by 90; at JAX's
    homographies (and JAX's angle) the fine outputs are within ATOL_MAPS."""
    j_yfcc, _, JCoarseAligner = jx
    jr, ja, resnet, align = nets
    pkl, scene = _rotated_scene(tmp_path, rng)
    coarse = JCoarseAligner(jr, nb_scale=1, n_iter=N_ITER, min_size=H_IMG,
                            rematch_per_call=True)
    kw = {k: v for k, v in PREDICT_KW.items() if k not in ("min_size", "nb_scale", "n_iter")}
    j_yfcc.predict_yfcc(pkl, scene, str(tmp_path / "jax"), coarse, ja, **kw)
    ref = artifacts.load_pair(str(tmp_path / "jax"), 0)
    assert int(ref["rotation"]) == 270

    yfcc.predict_yfcc(pkl, scene, str(tmp_path / "port"), resnet, align, "cpu", **PREDICT_KW)
    ours = artifacts.load_pair(str(tmp_path / "port"), 0)
    assert int(ours["rotation"]) == 270 and set(ours) == set(ref)

    def jax_angle(coarse, img_t, bg_mask_fn=None, dispatch=False):
        k = yfcc.ANGLES.index(int(ref["rotation"]))
        return yfcc.ANGLES[k], img_t.rotate(yfcc.ANGLES[k], expand=True), k

    monkeypatch.setattr(yfcc, "pick_rotation", jax_angle)
    _replay(monkeypatch, ref["coarse_h"])
    yfcc.predict_yfcc(pkl, scene, str(tmp_path / "at_jax_h"), resnet, align, "cpu",
                      **PREDICT_KW)
    ours = artifacts.load_pair(str(tmp_path / "at_jax_h"), 0)
    for key in ref:
        assert ours[key].shape == ref[key].shape and ours[key].dtype == ref[key].dtype, key
        np.testing.assert_allclose(ours[key], ref[key], atol=ATOL_MAPS, rtol=0, err_msg=key)


def test_predict_yfcc_device_loop_and_pools(tmp_path, rng, nets, monkeypatch):
    """n_devices=1 dispatches the four rotations' fits, reads their counts
    back once, picks 270 and runs the device-resident loop; batched pairs
    and a pool of two slots on the CPU write the same artifacts bit for bit,
    the rotation included; a pool of 2 CPU devices raises, naming the
    count."""
    _, _, resnet, align = nets
    pkl, scene = _rotated_scene(tmp_path, rng)
    calls = {"dispatch": 0, "fused": 0}
    dispatch, fused = CoarseAligner.dispatch_inlier_count, yfcc.multi_homography_dispatch

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(CoarseAligner, "dispatch_inlier_count", counting("dispatch", dispatch))
    monkeypatch.setattr(yfcc, "multi_homography_dispatch", counting("fused", fused))
    yfcc.predict_yfcc(pkl, scene, str(tmp_path / "fused"), resnet, align, "cpu", n_devices=1,
                      **PREDICT_KW)
    assert calls == {"dispatch": 4, "fused": 1}
    art = artifacts.load_pair(str(tmp_path / "fused"), 0)
    assert int(art["rotation"]) == 270
    h = art["coarse_h"][0] / art["coarse_h"][0, 2, 2]
    tx, ty = h[0, 2] * (W_IMG - 1) / 2, h[1, 2] * (H_IMG - 1) / 2  # the planted shift, px
    assert abs(tx - DX_PX) < 1 and abs(ty - DY_PX) < 1, (tx, ty)
    for name, pool in (("batched", dict(n_devices=1, batch_pairs=4)),
                       ("two_slots", dict(n_devices=["cpu", "cpu"]))):
        yfcc.predict_yfcc(pkl, scene, str(tmp_path / name), resnet, align, "cpu",
                          **dict(PREDICT_KW, **pool))
        other = artifacts.load_pair(str(tmp_path / name), 0)
        assert set(other) == set(art)
        for key in art:
            np.testing.assert_array_equal(other[key], art[key], err_msg=f"{name} {key}")
    with pytest.raises(RuntimeError, match="2 cpu devices: this machine has 1"):
        yfcc.predict_yfcc(pkl, scene, str(tmp_path / "x"), resnet, align, "cpu",
                          **dict(PREDICT_KW, n_devices=2))


@pytest.mark.parametrize("angle", [0, 90, 180, 270])
def test_matches_from_flow_equals_jax(rng, jx, angle):
    j_yfcc = jx[0]
    flow = rng.uniform(-1, 1, (W_IMG, W_IMG, 2)).astype(np.float32)
    keep = rng.rand(W_IMG, W_IMG) > 0.5
    for ours, ref in zip(yfcc.matches_from_flow(flow, keep, (W_IMG, H_IMG), (W_IMG, H_IMG), angle),
                         j_yfcc.matches_from_flow(flow, keep, (W_IMG, H_IMG), (W_IMG, H_IMG),
                                                  angle)):
        np.testing.assert_array_equal(ours, ref)


def test_load_scene_calibration_equals_jax(tmp_path, rng, jx):
    _, _, scene, calib, _, _ = _yfcc_setup(tmp_path, rng, artifacts.save_pair)
    for ours, ref, rec in zip(yfcc.load_scene_calibration(scene, H_IMG),
                              jx[0].load_scene_calibration(scene, H_IMG), calib):
        assert set(ours) == set(ref)
        for key in ref:
            np.testing.assert_array_equal(np.asarray(ours[key]), np.asarray(ref[key]))
            np.testing.assert_array_equal(np.asarray(ours[key]), np.asarray(rec[key]))


def test_evaluate_yfcc_matches_jax(tmp_path, rng, jx, monkeypatch):
    """On JAX-written artifacts of a calibrated two-view scene: the points
    each package hands to its pose estimator are the same sets (but pixels
    within 1e-6 of th), the coordinates within 1e-5 (w - 1) / 2 px; with
    each package's own estimator the pose errors agree within POSE_DEG, and
    the calibration given as records gives the same result as the h5 files."""
    j_yfcc = jx[0]
    from ransacflow_tpu.eval.artifacts import save_pair as j_save_pair

    pred_dir, pkl, scene, calib, R_b, t_b = _yfcc_setup(tmp_path, rng, j_save_pair)
    kw = dict(multi_h=True, th=0.95, use_ransac=True, threshold=0.0005, min_size=H_IMG)
    seen = _record_pose_inputs(monkeypatch, yfcc)
    seen_ref = _record_pose_inputs(monkeypatch, j_yfcc)
    errors, accs = yfcc.evaluate_yfcc(pred_dir, pkl, scene, "cpu", **kw)
    ref_errors, ref_accs = j_yfcc.evaluate_yfcc(pred_dir, pkl, scene, **kw)
    assert len(seen) == len(seen_ref) == 2  # pair 2 has no artifact
    tol = 1e-5 * (W_IMG - 1) / 2 / YFCC_FOCAL  # normalized by the focal length
    for i in range(2):
        _same_points(seen[i], seen_ref[i], _near_threshold_keys(pred_dir, i, calib), tol)
        assert 500 < len(seen[i][0])
    np.testing.assert_allclose(errors, ref_errors, atol=POSE_DEG, rtol=0)
    assert errors[2] == ref_errors[2] == 180.0
    assert max(errors[:2]) < 5.0  # the scene's own pose
    assert accs == ref_accs
    assert yfcc.evaluate_yfcc(pred_dir, pkl, scene, "cpu", calibration=calib, **kw) == \
        (errors, accs)


def test_aachen_export_matches_jax(tmp_path, rng, nets, jx, monkeypatch):
    """At JAX's homographies: db_xy equal, query_xy within 1e-3 px, and the
    match file byte for byte JAX's for the same correspondences."""
    _, j_aachen, JCoarseAligner = jx
    jr, ja, resnet, align = nets
    src, tgt = _translation_pair(rng)
    src.save(tmp_path / "q.png")
    tgt.save(tmp_path / "d.png")
    preds = []
    predict = j_aachen.multi_homography_predict
    monkeypatch.setattr(j_aachen, "multi_homography_predict",
                        lambda *a, **k: preds.append(predict(*a, **k)) or preds[-1])
    kw = dict(match_th=0.1, max_coarse=1)  # the in-bounds pixels (seeded nets: ~0.25)
    ref = j_aachen.export_correspondences(
        JCoarseAligner(jr, nb_scale=1, n_iter=N_ITER, min_size=H_IMG), ja,
        str(tmp_path / "q.png"), str(tmp_path / "d.png"), **kw)
    _replay(monkeypatch, preds[0]["coarse_h"])
    ours = aachen.export_correspondences(
        CoarseAligner(resnet, "cpu", nb_scale=1, n_iter=N_ITER, min_size=H_IMG), align,
        str(tmp_path / "q.png"), str(tmp_path / "d.png"), **kw)
    assert len(ours["db_xy"]) > 0
    np.testing.assert_array_equal(ours["db_xy"], ref["db_xy"])
    np.testing.assert_allclose(ours["query_xy"], ref["query_xy"], atol=1e-3, rtol=0)
    assert ours["query_size"] == ref["query_size"] and ours["db_size"] == ref["db_size"]
    for writer, name in ((aachen.write_match_file, "ours"), (j_aachen.write_match_file, "ref")):
        writer(str(tmp_path / name / "m.txt"), "q_d", ours)
        writer(str(tmp_path / name / "m.txt"), "q_d2", ref)
    assert (tmp_path / "ours" / "m.txt").read_bytes() == (tmp_path / "ref" / "m.txt").read_bytes()


def _shift_and_noise_pairs(tmp_path, rng):
    """Two CSV rows: a planted whole-cell shift (kept) and two noise images
    (rejected)."""
    img_dir = tmp_path / "imgs"
    os.makedirs(img_dir)
    base = _blocky(rng, H_IMG + 16, W_IMG + 16)
    for name, arr in (("a.png", base[:H_IMG, :W_IMG]), ("b.png", base[16:, 16:]),
                      ("n1.png", rng.rand(H_IMG, W_IMG, 3)),
                      ("n2.png", rng.rand(H_IMG, W_IMG, 3))):
        Image.fromarray((arr * 255).astype(np.uint8)).save(img_dir / name)
    (tmp_path / "pairs.csv").write_text("imgA,imgB\na.png,b.png\nn1.png,n2.png\n")
    return str(tmp_path / "pairs.csv"), str(img_dir)


def test_generate_pairs_bank_matches_equal_jax(tmp_path, rng, nets):
    """`pair_matches`: the 3-scale bank's mutual matches (src_idx where
    valid, and valid) equal the JAX align_pair's."""
    import jax.numpy as jnp

    from ransacflow_tpu.ops import mutual_matching as j_mutual_matching
    from ransacflow_tpu.pipeline.coarse import _coarse_feats as j_coarse_feats
    from ransacflow_tpu.utils.image import resize_round_stride, to_array

    jr, _, resnet, _ = nets
    csv_path, img_dir = _shift_and_noise_pairs(tmp_path, rng)
    img1, img2 = (Image.open(os.path.join(img_dir, n)).convert("RGB") for n in ("a.png", "b.png"))
    feats = [j_coarse_feats(jr, jnp.asarray(to_array(resize_round_stride(img1, s, 16)))[None])
             for s in (H_IMG // 2, H_IMG, 2 * H_IMG)]
    f2 = j_coarse_feats(jr, jnp.asarray(to_array(resize_round_stride(img2, H_IMG, 16)))[None])
    ref = j_mutual_matching(jnp.concatenate(feats, axis=0).T, f2.T)
    m, coords1, coords2, arr1, arr2 = generate_pairs.pair_matches(resnet, img1, img2, "cpu",
                                                                  H_IMG)
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(m.valid.numpy(), valid)
    np.testing.assert_array_equal(m.src_idx.numpy()[valid], np.asarray(ref.src_idx)[valid])
    assert valid.sum() > 50 and coords1.shape[0] == sum(f.shape[0] for f in feats)
    assert arr1.shape == arr2.shape == (H_IMG, W_IMG, 3)


def test_generate_pairs_cli_matches_jax(tmp_path, rng, nets, monkeypatch):
    """Both CLIs, on the same trunk, keep the shift pair and reject the
    noise pair and write the same first image. Their homographies (fit from
    other draws) agree within 1e-4. At JAX's homography the port's grid is
    JAX's within 1e-6, its sampling of JAX's grid JAX's warp within 1e-5,
    and its warp (kernel 5's homography form, plain version) JAX's within
    1e-4 before the uint8 cast: on the 160-px grid a sample on a step edge
    of the resized image moved by the grids' difference changes its value
    by more than 1e-5."""
    import jax.numpy as jnp

    from ransacflow_tpu.cli import generate_pairs as j_generate_pairs
    from ransacflow_tpu.ops import warp_grid as j_warp_grid

    jr, _, resnet, _ = nets
    csv_path, img_dir = _shift_and_noise_pairs(tmp_path, rng)
    argv = ["--pairCSV", csv_path, "--imgDir", img_dir, "--minSize", str(H_IMG),
            "--nbIter", "2000", "--minInliers", "45"]  # the shift ~61 inliers, the noise ~35
    fits = {"ours": [], "ref": []}
    warped = []

    def recording(module, key):
        align = module.align_pair
        monkeypatch.setattr(module, "align_pair",
                            lambda *a: fits[key].append(align(*a)) or fits[key][-1])

    recording(j_generate_pairs, "ref")
    monkeypatch.setattr(j_generate_pairs, "load_coarse_net", lambda *a: jr)
    grid_sample = j_generate_pairs.grid_sample
    monkeypatch.setattr(j_generate_pairs, "grid_sample",
                        lambda *a: warped.append(np.asarray(grid_sample(*a))[0])
                        or grid_sample(*a))
    monkeypatch.setattr(sys, "argv", ["generate_pairs", *argv, "--outDir",
                                      str(tmp_path / "ref")])
    j_generate_pairs.main()
    recording(generate_pairs, "ours")
    monkeypatch.setattr(generate_pairs, "load_coarse_net", lambda *a: resnet)
    generate_pairs.main([*argv, "--outDir", str(tmp_path / "ours"), "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "ours")) == sorted(os.listdir(tmp_path / "ref")) \
        == ["0_1.jpg", "0_2.jpg"]
    assert (tmp_path / "ours" / "0_1.jpg").read_bytes() == \
        (tmp_path / "ref" / "0_1.jpg").read_bytes()
    (n_ours, h_ours, _, arr2), (n_ref, h_ref, _, _) = fits["ours"][0], fits["ref"][0]
    assert n_ours > 45 and n_ref > 45 and fits["ours"][1][0] <= 45 >= fits["ref"][1][0]
    np.testing.assert_allclose(h_ours / h_ours[2, 2], h_ref / h_ref[2, 2], atol=1e-4, rtol=0)
    j_grid = np.array(j_warp_grid(jnp.asarray(h_ref)[None], H_IMG, W_IMG))
    _, grid = warp_sample.warp_homography_ref(
        torch.as_tensor(arr2)[None], torch.as_tensor(np.array(h_ref))[None], (H_IMG, W_IMG))
    np.testing.assert_allclose(grid.numpy(), j_grid, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        warp_sample.warp_sample_ref(torch.as_tensor(arr2)[None], torch.as_tensor(j_grid))[0],
        warped[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(generate_pairs.warp_to_first(arr2, h_ref, (H_IMG, W_IMG), "cpu"),
                               warped[0], atol=1e-4, rtol=0)


def test_resize_dataset_writes_jax_bytes(tmp_path, rng, monkeypatch):
    from ransacflow_tpu.cli import resize_dataset as j_resize_dataset

    os.makedirs(tmp_path / "in")
    for name, (w, h) in (("b.png", (97, 61)), ("a.jpg", (40, 130)), ("c.png", (480, 480))):
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(tmp_path / "in" / name)
    argv = ["--inputDir", str(tmp_path / "in"), "--maxSize", "64"]
    resize_dataset.main([*argv, "--outputDir", str(tmp_path / "ours")])
    monkeypatch.setattr(sys, "argv", ["resize_dataset", *argv, "--outputDir",
                                      str(tmp_path / "ref")])
    j_resize_dataset.main()
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "ours")) == ["0.png", "1.png", "2.png"]
    for name in names:
        assert (tmp_path / "ours" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()


def test_eval_yfcc_cli(tmp_path, rng):
    """`cli.eval_yfcc` in process on the CPU: predict on the turned pair,
    then results with --multiH --ransac."""
    pkl, scene = _rotated_scene(tmp_path, rng)
    eval_yfcc.main(["predict", "--testImg", str(tmp_path / "imgs"), "--testPair",
                    str(tmp_path / "pairs"), "--testScene", "reichstag", "--outDir",
                    str(tmp_path / "pred"), "--minSize", str(H_IMG), "--nbScale", "1",
                    "--coarseIter", "1000", "--maxCoarse", "0", "--device", "cpu"])
    art = artifacts.load_pair(str(tmp_path / "pred" / "reichstag"), 0)
    assert int(art["rotation"]) in yfcc.ANGLES  # the CLI's own seeded trunk
    with open(os.path.join(scene, "calibration.txt"), "w") as f:
        f.write("calib0.h5\ncalib1.h5\n")
    import h5py

    for name in ("calib0.h5", "calib1.h5"):
        with h5py.File(os.path.join(scene, name), "w") as h5:
            h5["R"], h5["T"] = np.eye(3), np.zeros((1, 3)) + (name == "calib1.h5")
            h5["K"] = np.diag([YFCC_FOCAL, YFCC_FOCAL, 1.0])
            h5["imsize"] = np.array([[W_IMG, H_IMG]])
    out = tmp_path / "out.json"
    eval_yfcc.main(["results", "--predDir", str(tmp_path / "pred"), "--gtPath",
                    str(tmp_path / "imgs"), "--testPair", str(tmp_path / "pairs"), "--scene",
                    "2", "--multiH", "--ransac", "--th", "0.0", "--minSize", str(H_IMG),
                    "--outRes", str(out), "--device", "cpu"])
    import json

    res = json.loads(out.read_text())
    assert set(res) == {"reichstag", "accs"} and len(res["reichstag"]) == 1
    assert np.isfinite(res["reichstag"][0])
    assert set(res["accs"]) == {"acc5", "acc10", "acc15", "acc20", "mAP"}


@pytest.mark.parametrize("flag,item", [(["--nDevices", "2"], "item 12"),
                                       (["--batchPairs", "2"], "item 12"),
                                       (["--computeDtype", "bfloat16"], "item 14")])
def test_eval_yfcc_cli_rejects_what_is_not_ported(tmp_path, rng, monkeypatch, flag, item):
    """--nDevices 2 on a machine with one device (the CPU) raises, naming the
    count. The flags of items 12a and 14 run now:
    --batchPairs 2 with --fused writes --fused's artifact bit for bit, and
    --computeDtype bfloat16 hands `predict_yfcc` networks cast to bf16 and
    writes a finite fp32 artifact with its rotation."""
    _rotated_scene(tmp_path, rng)
    argv = ["predict", "--testImg", str(tmp_path / "imgs"), "--testPair",
            str(tmp_path / "pairs"), "--testScene", "reichstag", "--minSize", str(H_IMG),
            "--nbScale", "1", "--coarseIter", "300", "--maxCoarse", "0", "--device", "cpu"]
    out = lambda name: ["--outDir", str(tmp_path / name)]  # noqa: E731
    if flag[0] == "--nDevices":
        with pytest.raises(RuntimeError, match="2 cpu devices: this machine has 1"):
            eval_yfcc.main([*argv, *out("x"), *flag])
        return
    if flag[0] == "--batchPairs":
        eval_yfcc.main([*argv, *out("fused"), "--fused"])
        eval_yfcc.main([*argv, *out("batched"), "--fused", *flag])
        a = artifacts.load_pair(str(tmp_path / "fused" / "reichstag"), 0)
        b = artifacts.load_pair(str(tmp_path / "batched" / "reichstag"), 0)
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        return
    seen = []
    predict = eval_yfcc.predict_yfcc
    monkeypatch.setattr(eval_yfcc, "predict_yfcc",
                        lambda *a, **k: seen.append(a) or predict(*a, **k))
    eval_yfcc.main([*argv, *out("bf16"), *flag])
    for net in (seen[0][3], *seen[0][4].values()):
        assert {t.dtype for t in net.state_dict().values() if t.is_floating_point()} == \
            {torch.bfloat16}
    art = artifacts.load_pair(str(tmp_path / "bf16" / "reichstag"), 0)
    assert int(art["rotation"]) in yfcc.ANGLES
    for key in ("coarse_h", "fine_flow_down8", "fine_match_down8"):
        assert art[key].dtype == np.float32 and np.isfinite(art[key]).all(), key
