"""Parity of the port's eval predict passes and CLIs with the JAX package,
on the CPU, on the JAX tests' 160-px synthetic sets (tests/test_eval.py).

The port's RANSAC draws are Philox from `SeedSequence([seed, index])`, JAX's
`fold_in(PRNGKey(seed), index)`, so the artifacts cannot be equal bit for
bit. The predict passes are held to JAX in two ways: the planted translation
is recovered (JAX's own checks), and at JAX's homographies (the port's
`CoarseAligner.get_coarse` replays the H stack of JAX's artifact) the fine
outputs equal JAX's within ATOL_MAPS. Weights are JAX's init trees carried
over by the port's `models/convert`.
"""

import os

import numpy as np
import jax
import pytest
import torch

from ransacflow_tpu import eval as j_eval
from ransacflow_tpu.models import init_resnet50_layer3 as j_init_resnet
from ransacflow_tpu.pipeline import init_alignment_params as j_init_align
from ransacflow_tpu_torch.cli import common as cli_common
from ransacflow_tpu_torch.cli import eval_corr, eval_hpatches, eval_kitti
from ransacflow_tpu_torch.eval import artifacts, corr, hpatches, kitti, pooled
from ransacflow_tpu_torch.models import convert, segnet
from ransacflow_tpu_torch.pipeline import CoarseAligner
from test_torch_eval import (
    H_IMG,
    W_IMG,
    _fg_border_mask,
    _kitti_gt,
    _translation_pair,
    _write_corr_dataset,
    _write_hpatches_dataset,
    _write_png16,
)

ATOL_MAPS = 1e-4  # fp32 conv stacks in two libraries (~20 convolutions)
N_ITER = 3000


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def nets():
    jr = j_init_resnet(jax.random.PRNGKey(0))
    ja = j_init_align(jax.random.PRNGKey(1))
    return jr, ja, convert.resnet50_layer3_from_tree(jr, "cpu"), \
        convert.alignment_params_from_tree(ja, "cpu")


def _bg(path, hw):
    return _fg_border_mask(*hw)


def _replay(monkeypatch, hs):
    """`CoarseAligner.get_coarse` returns the homographies `hs` in turn,
    then finds none."""
    stack = list(hs)

    def get_coarse(self, exclusion_mask=None, injected_samples=None):
        return (stack.pop(0), None) if stack else (None, None)

    monkeypatch.setattr(CoarseAligner, "get_coarse", get_coarse)


def _same_schema(ours, ref, fine_keys):
    assert set(ours) == set(ref)
    for key in ref:
        assert ours[key].shape == ref[key].shape and ours[key].dtype == ref[key].dtype, key
        assert np.isfinite(ours[key]).all(), key
    for key in fine_keys:
        np.testing.assert_allclose(ours[key], ref[key], atol=ATOL_MAPS, rtol=0, err_msg=key)


def _hpatches_case(tmp_path, rng):
    csv_dir, image_dir = _write_hpatches_dataset(tmp_path, rng)
    kw = dict(scenes=(2,), min_size=H_IMG, nb_scale=1, n_iter=N_ITER, max_coarse=1,
              bg_mask_fn=_bg)
    return csv_dir, image_dir, kw


def test_predict_hpatches_matches_jax(tmp_path, rng, nets, monkeypatch):
    jr, ja, resnet, align = nets
    csv_dir, image_dir, kw = _hpatches_case(tmp_path, rng)
    j_eval.predict_hpatches(csv_dir, image_dir, str(tmp_path / "jax"), jr, ja, **kw)
    ref = j_eval.load_pair(str(tmp_path / "jax" / "2"), 0)

    hpatches.predict_hpatches(csv_dir, image_dir, str(tmp_path / "port"), resnet, align,
                              "cpu", **kw)
    ours = artifacts.load_pair(str(tmp_path / "port" / "2"), 0)
    _same_schema(ours, ref, ())  # own draws: the schema and the planted geometry
    res, _ = hpatches.evaluate_hpatches(str(tmp_path / "port"), csv_dir, image_dir, "cpu",
                                        scenes=(2,), out_size=160, only_coarse=True)
    assert res[2] < 1.0, res

    _replay(monkeypatch, ref["coarse_h"])  # JAX's homographies: JAX's fine outputs
    hpatches.predict_hpatches(csv_dir, image_dir, str(tmp_path / "at_jax_h"), resnet, align,
                              "cpu", **kw)
    ours = artifacts.load_pair(str(tmp_path / "at_jax_h" / "2"), 0)
    _same_schema(ours, ref, ("coarse_h", "fine_flow_down8", "fine_match_down8", "bg_mask"))


def _same_artifacts(dir_a, dir_b, ids):
    """The pair artifacts `ids` of two output directories, bit for bit."""
    for i in ids:
        a, b = artifacts.load_pair(dir_a, i), artifacts.load_pair(dir_b, i)
        assert a is not None and set(a) == set(b), i
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{i} {key}")


def test_predict_hpatches_fused_and_pools(tmp_path, rng, nets, monkeypatch):
    """n_devices=1 runs each pair through the pool's device-resident loop
    and recovers the translation; batched pairs and a pool of two slots on
    the CPU write the same artifacts bit for bit; a pool of 2 CPU devices
    raises, naming the count."""
    _, _, resnet, align = nets
    csv_dir, image_dir, kw = _hpatches_case(tmp_path, rng)
    calls = []
    dispatch = pooled.multi_homography_dispatch
    monkeypatch.setattr(pooled, "multi_homography_dispatch",
                        lambda *a, **k: calls.append(1) or dispatch(*a, **k))
    hpatches.predict_hpatches(csv_dir, image_dir, str(tmp_path / "fused"), resnet, align,
                              "cpu", n_devices=1, **kw)
    assert calls == [1]
    res, _ = hpatches.evaluate_hpatches(str(tmp_path / "fused"), csv_dir, image_dir, "cpu",
                                        scenes=(2,), out_size=160, only_coarse=True)
    assert res[2] < 1.0, res
    for name, pool in (("batched", dict(n_devices=1, batch_pairs=4)),
                       ("two_slots", dict(n_devices=["cpu", "cpu"]))):
        hpatches.predict_hpatches(csv_dir, image_dir, str(tmp_path / name), resnet, align,
                                  "cpu", **dict(kw, **pool))
        _same_artifacts(str(tmp_path / "fused" / "2"), str(tmp_path / name / "2"), [0])
    with pytest.raises(RuntimeError, match="2 cpu devices: this machine has 1"):
        hpatches.predict_hpatches(csv_dir, image_dir, str(tmp_path / "x"), resnet, align,
                                  "cpu", **dict(kw, n_devices=2))


def test_predict_corr_matches_jax(tmp_path, rng, nets, monkeypatch):
    jr, ja, resnet, align = nets
    csv_path, img_dir = _write_corr_dataset(tmp_path, rng)
    kw = dict(min_size=H_IMG, nb_scale=1, n_iter=N_ITER, max_coarse=0)
    j_eval.predict_corr(csv_path, img_dir, str(tmp_path / "jax"), jr, ja,
                        bg_mask_fn=lambda row, hw: _fg_border_mask(*hw), **kw)
    ref = j_eval.load_pair(str(tmp_path / "jax"), 0)

    seen = []
    corr.predict_corr(csv_path, img_dir, str(tmp_path / "port"), resnet, align, "cpu",
                      bg_mask_fn=lambda path, hw: seen.append(path) or _bg(path, hw), **kw)
    assert seen == [os.path.join(img_dir, "b.jpg")]  # the target's path
    _same_schema(artifacts.load_pair(str(tmp_path / "port"), 0), ref, ())
    prec, total = corr.evaluate_corr(str(tmp_path / "port"), csv_path, img_dir, "cpu",
                                     min_size=H_IMG)[0.0]
    assert total == 12 and prec[-1] > 0.8, prec

    _replay(monkeypatch, ref["coarse_h"])
    corr.predict_corr(csv_path, img_dir, str(tmp_path / "at_jax_h"), resnet, align, "cpu",
                      bg_mask_fn=_bg, **kw)
    _same_schema(artifacts.load_pair(str(tmp_path / "at_jax_h"), 0), ref,
                 ("coarse_h", "fine_flow_down8", "fine_match_down8", "bg_mask"))


def _kitti_dataset(tmp_path, rng, n_pairs=1):
    img_dir = tmp_path / "image_2"
    gt_dir = tmp_path / "flow_noc"
    os.makedirs(img_dir)
    os.makedirs(gt_dir)
    for i in range(n_pairs):
        src, tgt = _translation_pair(rng)
        src.save(img_dir / f"{i:06}_11.png")
        tgt.save(img_dir / f"{i:06}_10.png")
        _write_png16(gt_dir / f"{i:06}_10.png", _kitti_gt(H_IMG, W_IMG, rng, invalid=0.0))
    return str(img_dir), str(gt_dir)


KITTI_KW = dict(coarse_size=H_IMG, fine_size=128, nb_scale=1, n_iter=N_ITER, max_coarse=0,
                bg_mask_fn=_bg)


def test_predict_kitti_matches_jax(tmp_path, rng, nets, monkeypatch):
    jr, ja, resnet, align = nets
    img_dir, gt_dir = _kitti_dataset(tmp_path, rng)
    j_eval.predict_kitti(img_dir, str(tmp_path / "jax"), jr, ja, end_index=1, **KITTI_KW)
    ref = j_eval.load_pair(str(tmp_path / "jax"), 0)

    kitti.predict_kitti(img_dir, str(tmp_path / "port"), resnet, align, "cpu", end_index=1,
                        **KITTI_KW)
    _same_schema(artifacts.load_pair(str(tmp_path / "port"), 0), ref, ())
    epe, _ = kitti.evaluate_kitti(str(tmp_path / "port"), gt_dir, "cpu", n_pairs=1,
                                  only_coarse=True)
    assert epe < 1.5, epe  # JAX's own check (tests/test_eval.py)
    fine, _ = kitti.evaluate_kitti(str(tmp_path / "port"), gt_dir, "cpu", n_pairs=1,
                                   th=0.0, cc_th=0.0)
    assert np.isfinite(fine)

    _replay(monkeypatch, ref["coarse_h"])
    kitti.predict_kitti(img_dir, str(tmp_path / "at_jax_h"), resnet, align, "cpu",
                        end_index=1, **KITTI_KW)
    _same_schema(artifacts.load_pair(str(tmp_path / "at_jax_h"), 0), ref,
                 ("coarse_h", "fine_flow_down8", "fine_match_down8", "fine_flow_d2_down8",
                  "bg_mask"))


def test_predict_kitti_restart_writes_the_full_runs_artifact(tmp_path, rng, nets):
    """The draws are reseeded per pair index: pair 1 from a run that
    begins there equals pair 1 of the full run, bit for bit."""
    _, _, resnet, align = nets
    img_dir, _ = _kitti_dataset(tmp_path, rng, n_pairs=2)
    kw = dict(KITTI_KW, n_iter=500)
    kitti.predict_kitti(img_dir, str(tmp_path / "full"), resnet, align, "cpu", end_index=2, **kw)
    kitti.predict_kitti(img_dir, str(tmp_path / "rest"), resnet, align, "cpu", begin_index=1,
                        end_index=2, **kw)
    assert artifacts.check_complete(str(tmp_path / "rest"), [0, 1]) == [0]
    full, rest = (artifacts.load_pair(str(tmp_path / d), 1) for d in ("full", "rest"))
    assert set(full) == set(rest)
    for key in full:
        np.testing.assert_array_equal(full[key], rest[key])


# ---------------------------------------------------------------------------
# the CLIs, in process
# ---------------------------------------------------------------------------

SMALL = ["--device", "cpu", "--nbScale", "1", "--coarseIter", "300"]


def test_eval_hpatches_cli(tmp_path, rng, monkeypatch, capsys):
    csv_dir, image_dir = _write_hpatches_dataset(tmp_path, rng)
    paths = ["--csv-path", csv_dir, "--image-data-path", image_dir]
    calls = []
    dispatch = pooled.multi_homography_dispatch
    monkeypatch.setattr(pooled, "multi_homography_dispatch",
                        lambda *a, **k: calls.append(1) or dispatch(*a, **k))
    for scene in (3, 4, 5, 6):  # the CLI reads scenes 2-6
        os.link(os.path.join(csv_dir, "hpatches_1_2.csv"),
                os.path.join(csv_dir, f"hpatches_1_{scene}.csv"))
    pred = str(tmp_path / "pred")
    eval_hpatches.main(["predict", *paths, "--outDir", pred, *SMALL, "--minSize", "160",
                        "--maxCoarse", "0", "--fused"])
    assert calls == [1] * 5
    assert all(artifacts.check_complete(os.path.join(pred, str(s)), [0]) == []
               for s in range(2, 7))
    eval_hpatches.main(["results", "--predDir", pred, *paths, "--device", "cpu", "--multiH",
                        "--minSize", "64"])
    out = capsys.readouterr().out
    assert "Scene 2, Average end-point error (EPE)" in out and "Overall mean AEPE" in out


def _cli_case(cli, tmp_path, rng):
    """(CLI module, its predict function's name, the index of the coarse
    trunk among that function's arguments, the predict arguments on a
    160-px set, the artifact directories under --outDir)."""
    if cli == "hpatches":
        csv_dir, image_dir = _write_hpatches_dataset(tmp_path, rng)
        for scene in (3, 4, 5, 6):  # the CLI reads scenes 2-6
            os.link(os.path.join(csv_dir, "hpatches_1_2.csv"),
                    os.path.join(csv_dir, f"hpatches_1_{scene}.csv"))
        return (eval_hpatches, "predict_hpatches", 3,
                ["--csv-path", csv_dir, "--image-data-path", image_dir, "--minSize", "160",
                 "--maxCoarse", "0"], [str(s) for s in range(2, 7)])
    if cli == "corr":
        csv_path, img_dir = _write_corr_dataset(tmp_path, rng)
        return (eval_corr, "predict_corr", 3,
                ["--testCSV", csv_path, "--testDir", img_dir, "--minSize", "160",
                 "--maxCoarse", "0"], [""])
    img_dir, _ = _kitti_dataset(tmp_path, rng)
    return (eval_kitti, "predict_kitti", 2,
            ["--testImg", img_dir, "--coarseSize", "160", "--fineSize", "128",
             "--endIndex", "1"], [""])


@pytest.mark.parametrize("cli,flags,item", [
    *[(cli, ["--nDevices", "2"], "item 12") for cli in ("hpatches", "corr", "kitti")],
    *[(cli, ["--batchPairs", "2", "--fused"], "item 12") for cli in ("hpatches", "corr")],
    *[(cli, ["--computeDtype", "bfloat16"], "item 14") for cli in ("hpatches", "corr", "kitti")],
])
def test_eval_clis_reject_what_is_not_ported(tmp_path, rng, monkeypatch, cli, flags, item):
    """--nDevices 2 on a machine with one device (the CPU) raises, naming the
    count. The flags of items 12a and 14 run now:
    --batchPairs 2 --fused writes --fused's artifacts bit for bit (eval_kitti
    has no --batchPairs, as the JAX CLI has none), and --computeDtype
    bfloat16 hands the harness networks cast to bf16, parameters and
    BatchNorm statistics alike, and writes finite fp32 artifacts."""
    main, fn_name, trunk_arg, args, subdirs = _cli_case(cli, tmp_path, rng)
    argv = ["predict", *args, *SMALL]
    if flags[0] == "--nDevices":
        with pytest.raises(RuntimeError, match="2 cpu devices: this machine has 1"):
            main.main([*argv, "--outDir", str(tmp_path / "x"), *flags])
        return
    if flags[0] == "--batchPairs":
        main.main([*argv, "--outDir", str(tmp_path / "fused"), "--fused"])
        main.main([*argv, "--outDir", str(tmp_path / "batched"), *flags])
        for sub in subdirs:
            _same_artifacts(str(tmp_path / "fused" / sub), str(tmp_path / "batched" / sub),
                            [0])
        return
    seen = []
    predict = getattr(main, fn_name)
    monkeypatch.setattr(main, fn_name, lambda *a, **k: seen.append(a) or predict(*a, **k))
    main.main([*argv, "--outDir", str(tmp_path / "bf16"), *flags])
    resnet, align = seen[0][trunk_arg], seen[0][trunk_arg + 1]
    for net in (resnet, *align.values()):
        assert {t.dtype for t in net.state_dict().values() if t.is_floating_point()} == \
            {torch.bfloat16}
    for sub in subdirs:
        art = artifacts.load_pair(str(tmp_path / "bf16" / sub), 0)
        for key in ("coarse_h", "fine_flow_down8", "fine_match_down8"):
            assert art[key].dtype == np.float32 and np.isfinite(art[key]).all(), key


def test_eval_corr_cli(tmp_path, rng, monkeypatch, capsys):
    """predict with --segNet hands the sky network the target image's path;
    then results."""
    csv_path, img_dir = _write_corr_dataset(tmp_path, rng)
    seen = []

    class Segmenter:
        def __init__(self, *args, **kwargs):
            pass

        def get_sky(self, img):
            seen.append(img)
            return np.zeros((8, 8), np.float32)

    monkeypatch.setattr(cli_common, "load_segnet", lambda *args: (None, None))
    monkeypatch.setattr(segnet, "SkySegmenter", Segmenter)
    pred = str(tmp_path / "pred")
    paths = ["--testCSV", csv_path, "--testDir", img_dir]
    eval_corr.main(["predict", *paths, "--outDir", pred, *SMALL, "--minSize", "160",
                    "--maxCoarse", "0", "--segNet"])
    assert seen == [os.path.join(img_dir, "b.jpg")]
    assert artifacts.check_complete(pred, [0]) == []
    eval_corr.main(["results", "--predDir", pred, *paths, "--device", "cpu", "--minSize",
                    "160", "--multiH", "--matchabilityTH", "0", "0.5"])
    out = capsys.readouterr().out
    assert "pixel thresholds:" in out and "threshold 0.5, precision" in out


def test_eval_kitti_cli(tmp_path, rng, capsys):
    img_dir, gt_dir = _kitti_dataset(tmp_path, rng)
    pred = str(tmp_path / "pred")
    eval_kitti.main(["predict", "--testImg", img_dir, "--outDir", pred, *SMALL,
                     "--coarseSize", "160", "--fineSize", "128", "--endIndex", "1",
                     "--nDevices", "1"])
    art = artifacts.load_pair(pred, 0)
    assert art is not None and set(art) == set(artifacts.FIELDS) | {"fine_flow_d2_down8"}
    eval_kitti.main(["results", "--predDir", pred, "--gtPath", gt_dir, "--device", "cpu",
                     "--nPairs", "1", "--multiH", "--interpolate"])
    assert "Average end-point error (EPE)" in capsys.readouterr().out
