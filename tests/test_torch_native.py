"""The port's native Lanczos resampler (`ransacflow_tpu_torch.native`, the
training data's `--nativeResize`) against the JAX package's and PIL, on the
CPU.

Both packages compile the same `resize.cpp` with the same g++ and flags, so
their outputs are compared bit for bit. A failed build raises: the port has
no PIL fallback.
"""

import numpy as np
import pytest
from PIL import Image

from ransacflow_tpu import native as jnative
from ransacflow_tpu.train import data as jdata
from ransacflow_tpu_torch import native
from ransacflow_tpu_torch.train import data
from ransacflow_tpu_torch.train.data import PairFolder


def _pil_resize_f32(img, out_h, out_w):
    return np.stack([np.asarray(Image.fromarray(img[:, :, i], mode="F").resize(
        (out_w, out_h), resample=Image.LANCZOS)) for i in range(img.shape[2])], axis=-1)


@pytest.mark.parametrize("shape", [(64, 80, 3), (100, 60, 3), (37, 53, 1)])
@pytest.mark.parametrize("out", [(32, 48), (128, 96), (37, 53)])
def test_lanczos_resize_is_jax_native_bit_for_bit(rng, shape, out):
    """Down, up and same-size resizes equal JAX's native resampler's bit for
    bit (one source, one compiler and flags)."""
    assert jnative.native_available()
    img = rng.rand(*shape).astype(np.float32)
    ours = native.lanczos_resize(img, *out)
    assert ours.shape == (*out, shape[2]) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, jnative.lanczos_resize(img, *out))


@pytest.mark.parametrize("out", [(32, 48), (128, 96)])
def test_lanczos_resize_matches_pil(rng, out):
    """Against PIL's float ('F') LANCZOS to 2e-3 (tests/test_native.py's
    tolerance: PIL's fixed-point coefficients), and the threads split rows
    without changing a bit."""
    img = rng.rand(64, 80, 3).astype(np.float32)
    ours = native.lanczos_resize(img, *out)
    np.testing.assert_allclose(ours, _pil_resize_f32(img, *out), atol=2e-3)
    np.testing.assert_array_equal(ours, native.lanczos_resize(img, *out, n_threads=1))
    np.testing.assert_array_equal(native.lanczos_resize(img[:, :, 0], *out), ours[:, :, :1])


def test_train_transform_native_matches_jax(rng):
    """`train_transform(use_native=True)` of both packages under one
    RandomState: the same crops bit for bit, the generators left in step."""
    for seed in range(6):
        i1 = Image.fromarray((rng.rand(70, 90, 3) * 255).astype(np.uint8))
        i2 = Image.fromarray((rng.rand(70, 90, 3) * 255).astype(np.uint8))
        r_ours, r_ref = np.random.RandomState(seed), np.random.RandomState(seed)
        ours = data.train_transform(i1, i2, 32, r_ours, use_native=True)
        ref = jdata.train_transform(i1, i2, 32, r_ref, use_native=True)
        for a, b in zip(ours, ref):
            assert a.shape == (32, 32, 3) and a.flags.c_contiguous
            np.testing.assert_array_equal(a, b)
        assert r_ours.rand() == r_ref.rand()


def test_pair_folder_native_batches(rng, tmp_path):
    for idx in range(2):
        for v in (1, 2):
            arr = (rng.rand(80, 100, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).save(tmp_path / f"{idx}_{v}.jpg")
    batches = [next(iter(f.epoch_batches(batch_size=2))) for f in (
        PairFolder(str(tmp_path), img_size=32, seed=0, use_native=True),
        jdata.PairFolder(str(tmp_path), img_size=32, seed=0, use_native=True))]
    assert batches[0]["I1"].shape == (2, 32, 32, 3) and batches[0]["I1"].dtype == np.float32
    for key in ("I1", "I2"):
        np.testing.assert_array_equal(batches[0][key], batches[1][key])


def test_build_without_gpp_raises(tmp_path, monkeypatch):
    """No g++ on PATH and no library built: the first call raises, and so
    does `train_transform(use_native=True)`; nothing falls back to PIL."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    img = np.zeros((8, 8, 3), np.float32)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.lanczos_resize(img, 4, 4)
    pil = Image.new("RGB", (40, 40))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        data.train_transform(pil, pil, 16, np.random.RandomState(0), use_native=True)


def test_build_lands_in_the_build_directory(tmp_path, monkeypatch):
    """The library is built into BUILD_DIR under a hashed name, and reused."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    native.lanczos_resize(np.ones((6, 6, 1), np.float32), 3, 3)
    libs = list((tmp_path / "build").glob("libresize_*.so"))
    assert len(libs) == 1
    mtime = libs[0].stat().st_mtime_ns
    monkeypatch.setattr(native, "_LIB", None)
    native.lanczos_resize(np.ones((6, 6, 1), np.float32), 3, 3)
    assert libs[0].stat().st_mtime_ns == mtime
