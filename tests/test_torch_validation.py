"""MegaDepth validation of the PyTorch port (`train/validation.py`,
`train/loop.fit(val_csv=...)`, `cli.train valMegaDepth`) against the JAX
package's, on the CPU.

The synthetic set is tests/test_validation.py's, written with the `csv`
module: two rows in one scene, planted pixel offsets under fixed coarse
affines, images whose min side is already the validation size. With
netFlowCoarse.conv4 zeroed the fine flow is exactly the coarse affine, so
each planted error is known and sits 0.05 px clear of every threshold: the
precision vectors must be equal. Weights are JAX's init trees, carried over
by `convert`.
"""

import csv
import json
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from ransacflow_tpu.pipeline import init_alignment_params as j_init_align
from ransacflow_tpu.train import validation as jvalidation
from ransacflow_tpu_torch.cli import train as cli_train
from ransacflow_tpu_torch.eval.table import read_rows
from ransacflow_tpu_torch.models import convert
from ransacflow_tpu_torch.train import loop, validation
from ransacflow_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from ransacflow_tpu_torch.train.loop import fit

MIN_SIZE = 64
DELTAS = np.array([0.5, 2.5, 4.0, 6.0, 10.0, 20.0, 30.0, 100.0])
THETAS = [np.array([[0.8, 0.0, 0.1], [0.0, 0.9, -0.05]], np.float32),
          np.array([[1.0, 0.05, -0.1], [0.02, 0.85, 0.0]], np.float32)]
ATOL_FLOW = 1e-4  # the fine pass's grid: fp32 conv stacks in two libraries


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _trees(zero_flow, key=0):
    params = j_init_align(jax.random.PRNGKey(key))
    if zero_flow:
        conv4 = params["netFlowCoarse"]["conv4"]["weight"]
        params["netFlowCoarse"]["conv4"]["weight"] = jnp.zeros_like(conv4)
    return params, convert.alignment_params_from_tree(params, "cpu")


def _affine_source_px(theta, xb, yb, wt, ht, ws, hs):
    xn = 2.0 * xb / (wt - 1) - 1.0
    yn = 2.0 * yb / (ht - 1) - 1.0
    sx_n = theta[0, 0] * xn + theta[0, 1] * yn + theta[0, 2]
    sy_n = theta[1, 0] * xn + theta[1, 1] * yn + theta[1, 2]
    return (sx_n + 1) * 0.5 * (ws - 1), (sy_n + 1) * 0.5 * (hs - 1)


def write_val_dataset(root, rng, min_size=MIN_SIZE, src_hw=(MIN_SIZE, 96),
                      tgt_hw=(80, MIN_SIZE), n_points=8):
    """tests/test_validation.py:57-112 with the `csv` module: returns
    (csv path, image dir, coarse .pkl path, expected precision (8,))."""
    scene = os.path.join(root, "val", "10")
    os.makedirs(scene)
    src = (rng.rand(*src_hw, 3) * 255).astype(np.uint8)
    tgt = (rng.rand(*tgt_hw, 3) * 255).astype(np.uint8)
    Image.fromarray(src).save(os.path.join(scene, "s.jpg"))
    Image.fromarray(tgt).save(os.path.join(scene, "t.jpg"))
    (hs, ws), (ht, wt) = src_hw, tgt_hw
    rows, hits, total = [], np.zeros(8), 0
    for theta, deltas in zip(THETAS, [np.resize(DELTAS, n_points), np.full(n_points, 0.2)]):
        xb = np.linspace(8, wt - 9, n_points).round()
        yb = np.linspace(8, ht - 9, n_points).round()
        sx, sy = _affine_source_px(theta, xb, yb, wt, ht, ws, hs)
        xa, ya = sx + deltas, sy
        err = np.sqrt((sx - xa.astype(int)) ** 2 + (sy - ya.astype(int)) ** 2)
        grid = validation.PIXEL_GRID
        assert np.abs(err.reshape(-1, 1) - grid.reshape(1, -1)).min() > 0.05
        hits += (err.reshape(-1, 1) < grid.reshape(1, -1)).sum(0)
        total += len(err)
        rows.append({"scene": "10", "source_image": "s.jpg", "target_image": "t.jpg",
                     "XA": ";".join(f"{v:.6f}" for v in xa),
                     "YA": ";".join(f"{v:.6f}" for v in ya),
                     "XB": ";".join(f"{v:.0f}" for v in xb),
                     "YB": ";".join(f"{v:.0f}" for v in yb)})
    csv_path = os.path.join(root, "val.csv")
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    pkl_path = os.path.join(root, "coarse.pkl")
    with open(pkl_path, "wb") as f:
        pickle.dump(THETAS, f)
    return csv_path, os.path.join(root, "val"), pkl_path, hits / total


def _write_train_dir(root, rng, n=4):
    data = os.path.join(root, "train")
    os.makedirs(data)
    for idx in range(n):
        for v in (1, 2):
            arr = (rng.rand(48, 48, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(data, f"{idx}_{v}.jpg"))
    return data


def test_pixel_grid_matches_jax():
    np.testing.assert_array_equal(validation.PIXEL_GRID, jvalidation.PIXEL_GRID)
    np.testing.assert_array_equal(validation.PIXEL_GRID, [1, 2, 3, 5, 8, 13, 22, 36])


@pytest.mark.parametrize("size_wh,min_size", [((200, 100), 80), ((333, 517), 160),
                                              ((640, 480), 480)])
def test_resize_min_resolution_matches_jax(rng, size_wh, min_size):
    img = Image.fromarray((rng.rand(size_wh[1], size_wh[0], 3) * 255).astype(np.uint8))
    x = rng.rand(5) * size_wh[0]
    y = rng.rand(5) * size_wh[1]
    ours = validation.resize_min_resolution(min_size, img, x, y)
    ref = jvalidation.resize_min_resolution(min_size, img, x, y)
    assert ours[0].size == ref[0].size and min(ours[0].size) % 16 == 0
    np.testing.assert_array_equal(np.asarray(ours[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(ours[1], ref[1])
    np.testing.assert_array_equal(ours[2], ref[2])


def test_alignment_error_matches_jax(rng):
    """The reference's int() truncation of both coordinate pairs; equal to
    JAX's bit for bit, and the exact case of tests/test_validation.py."""
    flow = (rng.rand(20, 30, 2) * 2 - 1).astype(np.float32)
    xa, ya = rng.rand(50) * 40, rng.rand(50) * 30
    xb, yb = rng.rand(50) * 29.9, rng.rand(50) * 19.9
    np.testing.assert_array_equal(
        validation.alignment_error(flow, xa, ya, xb, yb, 41, 31),
        jvalidation.alignment_error(flow, xa, ya, xb, yb, 41, 31))
    flow = np.zeros((4, 6, 2), np.float32)
    flow[2, 3] = [0.5, -0.5]
    err = validation.alignment_error(flow, np.array([7.5]), np.array([2.0]),
                                     np.array([3.0]), np.array([2.0]), 11, 9)
    np.testing.assert_allclose(err, [0.5], atol=1e-6)


@pytest.mark.parametrize("zero_flow", [True, False], ids=["zero_flow", "seeded"])
def test_validate_matches_jax(tmp_path, rng, zero_flow):
    """`validate` of both packages on the synthetic set: the precision
    vectors equal (and, with the zero flow, the planted one), each row's
    fine grid within 1e-4, the networks' modes restored."""
    import pandas as pd

    csv_path, val_dir, pkl_path, expected = write_val_dataset(str(tmp_path), rng)
    trees, nets = _trees(zero_flow)
    nets["netFeatCoarse"].train()
    rows = read_rows(csv_path)
    with open(pkl_path, "rb") as f:
        thetas = pickle.load(f)
    prec = validation.validate(rows, val_dir, thetas, nets, "cpu", min_size=MIN_SIZE)
    prec_ref = jvalidation.validate(pd.read_csv(csv_path, dtype=str), val_dir, thetas, trees,
                                    min_size=MIN_SIZE)
    np.testing.assert_array_equal(prec, prec_ref)
    if zero_flow:
        np.testing.assert_array_equal(prec, expected)
    assert nets["netFeatCoarse"].training and not nets["netFlowCoarse"].training
    for theta in thetas:
        src = np.asarray(Image.open(os.path.join(val_dir, "10", "s.jpg")), np.float32) / 255
        tgt = np.asarray(Image.open(os.path.join(val_dir, "10", "t.jpg")), np.float32) / 255
        with torch.inference_mode():
            nets["netFeatCoarse"].eval()
            ours = validation.fine_forward(nets, torch.from_numpy(src)[None],
                                           torch.from_numpy(tgt)[None],
                                           torch.from_numpy(theta)[None])
        ref = jvalidation._fine_forward(trees, jnp.asarray(src)[None], jnp.asarray(tgt)[None],
                                        jnp.asarray(theta)[None])
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL_FLOW)


def test_validate_raises_on_a_short_coarse_pkl(tmp_path, rng):
    """A coarse.pkl with fewer transforms than the CSV has rows raises, as
    the reference's `coarse_transforms[i]` does (an IndexError there),
    before any row is validated; the reference raises on the same lists."""
    import pandas as pd

    csv_path, val_dir, pkl_path, _ = write_val_dataset(str(tmp_path), rng)
    trees, nets = _trees(True)
    rows = read_rows(csv_path)
    with open(pkl_path, "rb") as f:
        thetas = pickle.load(f)
    assert len(thetas) == len(rows) > 1
    with pytest.raises(ValueError, match=f"{len(rows) - 1} coarse transforms for "
                                         f"{len(rows)} rows"):
        validation.validate(rows, val_dir, thetas[:-1], nets, "cpu", min_size=MIN_SIZE)
    with pytest.raises(IndexError):
        jvalidation.validate(pd.read_csv(csv_path, dtype=str), val_dir, thetas[:-1], trees,
                             min_size=MIN_SIZE)


def test_fit_best_model_gating(tmp_path, rng, monkeypatch):
    """tests/test_validation.py's gating: the model is saved on an
    improvement only, renamed with the best prec@8 at the end, no periodic
    checkpoints; each epoch logs its own prec@8; fit reports the best."""
    csv_path, val_dir, pkl_path, _ = write_val_dataset(str(tmp_path), rng)
    train_dir = _write_train_dir(str(tmp_path), rng)
    out_dir = str(tmp_path / "run")
    seq = iter([0.5, 0.8, 0.3])
    calls = []

    def fake_validate(rows, vdir, transforms, nets, device, kernel_size=7, min_size=480):
        calls.append((len(rows), len(transforms), vdir, min_size))
        p = np.zeros(8)
        p[4] = next(seq)
        return p

    monkeypatch.setattr(loop, "validate", fake_validate)
    _, nets = _trees(False)
    _, best = fit(nets, train_dir, out_dir, "cpu", epochs=3, batch_size=2, img_size=32,
                  margin=8, max_steps_per_epoch=1, val_csv=csv_path, val_dir=val_dir,
                  val_coarse_pkl=pkl_path, val_min_size=MIN_SIZE, epoch_save_model=1)
    assert best == 0.8 and calls == [(2, 2, val_dir, MIN_SIZE)] * 3
    assert not os.path.exists(os.path.join(out_dir, "BestModel"))
    final = os.path.join(out_dir, "BestModel@8_0.800")
    assert int(load_checkpoint(final)["step"]) == 1
    assert not any(p.startswith("checkpoint_epoch") for p in os.listdir(out_dir))
    logged = [json.loads(line) for line in open(os.path.join(out_dir, "metrics.jsonl"))]
    assert [r["val_prec8"] for r in logged if r["step"] < 3] == [0.5, 0.8, 0.3]


def test_fit_without_validation_logs_zero_and_checkpoints(tmp_path, rng):
    train_dir = _write_train_dir(str(tmp_path), rng)
    out_dir = str(tmp_path / "run")
    _, nets = _trees(False)
    _, best = fit(nets, train_dir, out_dir, "cpu", epochs=2, batch_size=2, img_size=32,
                  margin=8, max_steps_per_epoch=1, epoch_save_model=1)
    assert best == 0.0
    assert sorted(p for p in os.listdir(out_dir) if p.startswith("checkpoint")) == [
        "checkpoint_epoch0.pt", "checkpoint_epoch1.pt"]
    logged = [json.loads(line) for line in open(os.path.join(out_dir, "metrics.jsonl"))]
    assert [r["val_prec8"] for r in logged] == [0.0, 0.0]


def test_fit_validation_integration(tmp_path, rng):
    """The real `validate` inside `fit`: with lr 0 the zero-flow networks'
    conv4 stays 0, so the precision is the planted one and the rename
    carries it."""
    csv_path, val_dir, pkl_path, expected = write_val_dataset(str(tmp_path), rng)
    train_dir = _write_train_dir(str(tmp_path), rng)
    out_dir = str(tmp_path / "run")
    _, nets = _trees(True)
    _, best = fit(nets, train_dir, out_dir, "cpu", epochs=1, batch_size=2, img_size=32,
                  margin=8, lr=0.0, max_steps_per_epoch=1, val_csv=csv_path,
                  val_dir=val_dir, val_coarse_pkl=pkl_path, val_min_size=MIN_SIZE)
    assert best == expected[4]
    assert os.path.exists(os.path.join(out_dir, f"BestModel@8_{best:.3f}"))


def test_cli_train_val_megadepth_native(tmp_path, rng):
    """`cli.train --nativeResize valMegaDepth` for one epoch of 2 steps,
    warm-started from zero-flow networks at lr 0: the best model is written
    under its planted prec@8."""
    csv_path, val_dir, pkl_path, expected = write_val_dataset(str(tmp_path), rng)
    train_dir = _write_train_dir(str(tmp_path), rng)
    _, nets = _trees(True)
    resume = str(tmp_path / "zero_flow.pt")
    save_checkpoint(resume, nets)
    out_dir = tmp_path / "run"
    cli_train.main(["--trainImgDir", train_dir, "--outDir", str(out_dir), "--device", "cpu",
                    "--stage", "3", "--nEpochs", "1", "--batchSize", "2", "--imgSize", "32",
                    "--margin", "8", "--lr", "0", "--maxStepsPerEpoch", "2",
                    "--resumePth", resume, "--nativeResize", "valMegaDepth",
                    "--valImgDir", val_dir, "--valCSV", csv_path, "--inPklCoarse", pkl_path,
                    "--valMinSize", str(MIN_SIZE)])
    assert os.path.exists(out_dir / f"BestModel@8_{expected[4]:.3f}")
    logged = [json.loads(line) for line in open(out_dir / "metrics.jsonl")]
    assert logged[-1]["step"] == 0 and logged[-1]["val_prec8"] == expected[4]
