"""Parity of the port's eval harnesses' host and metric code with the JAX
package, on the CPU: the artifact schema read across packages, the CSV
reader against pandas, the 16-bit PNG reader against cv2, the compose core
(kernel 8's plain version) and the metric passes of HPatches, KITTI and the
sparse-correspondence harness on artifacts the JAX package wrote. The
synthetic writers are copies of tests/test_eval.py's, writing their CSVs
with the `csv` module. The `gpu` test holds the results passes on the card
to the CPU's; the card's machine has neither pandas nor cv2, so the JAX
package's eval modules (which import them) and pandas are imported inside
the tests that use them (`jx`).
"""

import csv
import os
import struct
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from ransacflow_tpu_torch.eval import artifacts, compose, corr, hpatches, kitti, table, yfcc
from ransacflow_tpu_torch.kernels.ransac import MAX_MATCHES
from ransacflow_tpu_torch.utils import image

H_IMG = W_IMG = 160
DX_PX, DY_PX = 16, 16  # one full feature cell each (stride 16)
BORDER = 32
ATOL_PX = 1e-4     # a metric in pixels, fp32 compose in two libraries
ATOL_FLOW = 1e-5   # normalized flows, fp32 compose in two libraries


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's counterparts, and pandas."""
    import pandas

    from ransacflow_tpu.eval import artifacts, compose, corr, hpatches, kitti
    from ransacflow_tpu.utils import image

    return SimpleNamespace(artifacts=artifacts, compose=compose, corr=corr, hpatches=hpatches,
                           kitti=kitti, image=image, pd=pandas)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# synthetic writers (tests/test_eval.py:43-71,137-158,504-538)
# ---------------------------------------------------------------------------


def _blocky(rng, h, w):
    base = (rng.rand(h // 4, w // 4, 3) > 0.5).astype(np.float32)
    return np.kron(base, np.ones((4, 4, 1), np.float32))[:h, :w]


def _translation_pair(rng):
    """(src PIL, tgt PIL): tgt(x, y) = src(x + DX, y + DY)."""
    import jax.numpy as jnp

    from ransacflow_tpu.ops import grid_sample as j_grid_sample
    from ransacflow_tpu.ops import warp_grid as j_warp_grid

    src_arr = _blocky(rng, H_IMG, W_IMG)
    tx, ty = 2 * DX_PX / W_IMG, 2 * DY_PX / H_IMG
    H21 = np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1]], np.float32)
    g = j_warp_grid(jnp.asarray(H21)[None], H_IMG, W_IMG)
    tgt_arr = np.asarray(j_grid_sample(jnp.asarray(src_arr)[None], g))[0]
    to_img = lambda a: Image.fromarray(  # noqa: E731
        (np.clip(a, 0, 1) * 255).astype(np.uint8))
    return to_img(src_arr), to_img(tgt_arr)


def _fg_border_mask(h, w, border=BORDER):
    m = np.zeros((h, w), np.float32)
    m[border:-border, border:-border] = 1.0
    return m


def _write_csv(path, rows):
    """`pandas.DataFrame(rows).to_csv(path, index=False)`."""
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


def _write_hpatches_dataset(tmp_path, rng, hs_px=None, pair=None):
    """One pair of images, by default the translation pair; a CSV row per
    pixel-space homography of `hs_px` (source px -> target px), by default
    the planted translation."""
    src, tgt = pair or _translation_pair(rng)
    obj_dir = tmp_path / "imgs" / "obj1"
    os.makedirs(obj_dir)
    src.save(obj_dir / "1.ppm")
    tgt.save(obj_dir / "2.ppm")
    if hs_px is None:
        hs_px = [np.array([[1, 0, -DX_PX], [0, 1, -DY_PX], [0, 0, 1]], np.float64)]
    rows = []
    for H_px in hs_px:
        row = {"obj": "obj1", "im1": 1, "im2": 2, "Him": H_IMG, "Wim": W_IMG}
        for r in range(3):
            for c in range(3):
                row[f"h{r}{c}"] = float(H_px[r, c])
        rows.append(row)
    csv_dir = tmp_path / "csv"
    os.makedirs(csv_dir)
    _write_csv(csv_dir / "hpatches_1_2.csv", rows)
    return str(csv_dir), str(tmp_path / "imgs")


def _write_corr_dataset(tmp_path, rng, n=12, n_rows=1, oob=0):
    """The translation pair and a CSV of `n_rows` rows of n annotated
    correspondences on the central region, `oob` of them moved off the
    image (dropped by the MegaDepth variant)."""
    src, tgt = _translation_pair(rng)
    img_dir = tmp_path / "imgs"
    os.makedirs(img_dir)
    src.save(img_dir / "a.jpg")
    tgt.save(img_dir / "b.jpg")
    rows = []
    for _ in range(n_rows):
        xt = rng.randint(BORDER, W_IMG - BORDER, n)
        yt = rng.randint(BORDER, H_IMG - BORDER, n)
        xs, ys = xt + DX_PX, yt + DY_PX
        xt[:oob] += W_IMG
        rows.append({
            "scene": "/", "source_image": "a.jpg", "target_image": "b.jpg",
            "XA": ";".join(map(str, xs)), "YA": ";".join(map(str, ys)),
            "XB": ";".join(map(str, xt)), "YB": ";".join(map(str, yt)),
        })
    csv_path = str(tmp_path / "pairs.csv")
    _write_csv(csv_path, rows)
    return csv_path, str(img_dir)


def _write_corr_accounting_setup(tmp_path, rng, save_pair):
    """2-row CSV over a 32px pair; artifact only for row 0 (written by
    `save_pair`), whose left half has low matchability (so th=0.0 and th=0.5
    accumulators differ and the reference's loop-variable leak is
    observable)."""
    size = 32
    img_dir = tmp_path / "imgs"
    os.makedirs(img_dir, exist_ok=True)
    arr = (rng.rand(size, size, 3) * 255).astype(np.uint8)
    Image.fromarray(arr).save(img_dir / "a.jpg")
    Image.fromarray(arr).save(img_dir / "b.jpg")
    # 2 points in the low-match left half, 2 in the high-match right half
    xt = np.array([4, 8, 24, 28])
    yt = np.array([16, 16, 16, 16])
    row = {
        "scene": "/", "source_image": "a.jpg", "target_image": "b.jpg",
        "XA": ";".join(map(str, xt)), "YA": ";".join(map(str, yt)),
        "XB": ";".join(map(str, xt)), "YB": ";".join(map(str, yt)),
    }
    csv_path = str(tmp_path / "pairs.csv")
    _write_csv(csv_path, [row, dict(row)])

    pred_dir = str(tmp_path / "pred")
    match = np.ones((1, 4, 4, 2), np.float32)
    match[:, :, :2, :] = 0.1  # left half unmatchable
    art = {
        "coarse_h": np.eye(3, dtype=np.float32)[None],
        "fine_flow_down8": np.zeros((1, 4, 4, 2), np.float32),
        "fine_match_down8": match,
        "bg_mask": np.ones((size, size), np.float32),
    }
    save_pair(pred_dir, 0, art)  # row 1 (index 1) stays missing
    return csv_path, str(img_dir), pred_dir, size


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _write_png16(path, img, filters=0, colour=2, depth=16, interlace=0):
    """A 16-bit RGB PNG of `img` (H, W, 3) uint16 given in cv2's B, G, R
    order, row y filtered with type filters[y] (a scalar: every row)."""
    h, w = img.shape[:2]
    raw = np.ascontiguousarray(img[..., ::-1]).astype(">u2").view(np.uint8)
    raw = raw.reshape(h, -1).astype(np.int32)
    kinds = np.broadcast_to(np.asarray(filters), (h,))
    zeros, prior, out = np.zeros(6, np.int32), np.zeros(raw.shape[1], np.int32), []
    for y in range(h):
        cur = raw[y]
        a = np.concatenate([zeros, cur[:-6]])
        c = np.concatenate([zeros, prior[:-6]])
        pred = (0, a, prior, (a + prior) // 2, _paeth(a, prior, c))[kinds[y]]
        out.append(bytes([kinds[y]]) + ((cur - pred) & 255).astype(np.uint8).tobytes())
        prior = cur
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    with open(path, "wb") as f:
        f.write(kitti.PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(b"".join(out))) + _chunk(b"IEND", b""))
    return str(path)


def _kitti_gt(h, w, rng, invalid=0.2):
    """KITTI's stored ground truth in cv2's order: (valid, v, u) with
    u = DX, v = DY planted and a share of invalid pixels."""
    u = np.full((h, w), DX_PX * 64 + 32768, np.uint16)
    v = np.full((h, w), DY_PX * 64 + 32768, np.uint16)
    ok = (rng.rand(h, w) > invalid).astype(np.uint16)
    return np.stack([ok, v, u], axis=-1)


# ---------------------------------------------------------------------------
# artifacts and CSV files
# ---------------------------------------------------------------------------


def _artifact(rng, n=2, h8=4, w8=5):
    return {
        "coarse_h": rng.randn(n, 3, 3).astype(np.float32),
        "fine_flow_down8": rng.randn(n, h8, w8, 2).astype(np.float32),
        "fine_match_down8": rng.rand(n, h8, w8, 2).astype(np.float32),
        "bg_mask": rng.rand(h8 * 8, w8 * 8) > 0.5,
    }


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_artifacts_read_across_packages(tmp_path, rng, writer, jx):
    """Either package's results pass reads the other's predict output."""
    save, load = ((jx.artifacts.save_pair, artifacts.load_pair) if writer == "jax"
                  else (artifacts.save_pair, jx.artifacts.load_pair))
    pred = _artifact(rng)
    extra = rng.randn(2, 3, 4, 2).astype(np.float32)
    save(str(tmp_path), 3, pred, fine_flow_d2_down8=extra)
    art = load(str(tmp_path), 3)
    assert artifacts.FIELDS == jx.artifacts.FIELDS
    assert set(art) == set(artifacts.FIELDS) | {"fine_flow_d2_down8"}
    for key in artifacts.FIELDS:
        assert art[key].dtype == pred[key].dtype
        np.testing.assert_array_equal(art[key], pred[key])
    np.testing.assert_array_equal(art["fine_flow_d2_down8"], extra)
    assert load(str(tmp_path), 99) is None
    assert (artifacts.check_complete(str(tmp_path), [3, 99])
            == jx.artifacts.check_complete(str(tmp_path), [3, 99]) == [99])


def test_hpatches_csv_reader_matches_pandas(tmp_path, rng, jx):
    """The fields the harness reads equal pandas'. The homography's floats
    equal pandas' round-trip parser's; its default parser (the JAX
    harness's) is not correctly rounded: on 17-digit values it may miss in
    the last digits (5e-13 relative seen here), on a few digits it agrees."""
    hs_px = [np.eye(3) + rng.randn(3, 3) * s for s in (0.0, 1e-3, 0.3, 10.0)]
    hs_px.append(np.round(hs_px[2], 6))
    csv_dir, _ = _write_hpatches_dataset(tmp_path, rng, hs_px)
    path = os.path.join(csv_dir, "hpatches_1_2.csv")
    rows = table.read_hpatches(path)
    df, exact = jx.pd.read_csv(path), jx.pd.read_csv(path, float_precision="round_trip")
    assert len(rows) == len(df) == len(hs_px)
    for row, (_, ref), (_, ref_exact) in zip(rows, df.iterrows(), exact.iterrows()):
        assert row["obj"] == str(ref.obj)
        assert f"{row['im1']}.ppm" == f"{ref.im1}.ppm" and f"{row['im2']}.ppm" == f"{ref.im2}.ppm"
        assert (row["Him"], row["Wim"]) == (int(ref.Him), int(ref.Wim))
        H = lambda r: r.iloc[5:].astype("double").values.reshape(3, 3)  # noqa: E731
        np.testing.assert_array_equal(row["H"], H(ref_exact))
        np.testing.assert_allclose(row["H"], H(ref), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(rows[-1]["H"], H(df.iloc[-1]))  # 6 decimals: equal


def test_corr_csv_reader_matches_pandas(tmp_path, rng, jx):
    csv_path, _ = _write_corr_dataset(tmp_path, rng, n_rows=3, oob=2)
    rows = table.read_rows(csv_path)
    df = jx.pd.read_csv(csv_path, dtype=str)
    assert len(rows) == len(df) == 3
    for row, (_, ref) in zip(rows, df.iterrows()):
        assert row == {k: str(v) for k, v in ref.items()}


# ---------------------------------------------------------------------------
# KITTI's 16-bit PNG ground truth
# ---------------------------------------------------------------------------


def _flow_png_content(h, w, rng):
    """Smooth flow channels (libpng picks Sub, Up, Average and Paeth rows for
    them) beside a block of noise, valid in {0, 1}."""
    y, x = np.mgrid[:h, :w]
    u = 32768 + np.round(64 * (0.02 * x + 3 * np.sin(y / 7.0))).astype(np.int64)
    v = 32768 + np.round(64 * (0.01 * y - 2 * np.cos(x / 11.0))).astype(np.int64)
    u[: h // 3, : w // 3] = rng.randint(0, 65536, u[: h // 3, : w // 3].shape)
    ok = rng.rand(h, w) > 0.3
    return np.stack([ok, v, u], axis=-1).astype(np.uint16)


@pytest.mark.parametrize("level", [0, 1, 9])
@pytest.mark.parametrize("hw", [(1, 1), (5, 7), (375, 1242)])
def test_read_kitti_flow_matches_cv2(tmp_path, hw, level, jx):
    cv2 = pytest.importorskip("cv2")  # cv2 writes the file
    rng = np.random.RandomState(sum(hw) + level)
    path = str(tmp_path / "000000_10.png")
    assert cv2.imwrite(path, _flow_png_content(*hw, rng), [cv2.IMWRITE_PNG_COMPRESSION, level])
    ours = kitti.read_png16(path)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert ours.dtype == ref.dtype == np.uint16
    np.testing.assert_array_equal(ours, ref)
    for a, b in zip(kitti.read_kitti_flow(path), jx.kitti.read_kitti_flow(path)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "mixed"])
def test_read_png16_undoes_each_filter(tmp_path, filters):
    """A file written with each of PNG's five filter types forced on every
    row, and with a random type a row, reads back its samples."""
    rng = np.random.RandomState(5)
    img = rng.randint(0, 65536, (9, 13, 3)).astype(np.uint16)
    img[4:] = img[4:, :1]  # runs: Paeth takes each of its three branches
    if filters == "mixed":
        filters = rng.randint(0, 5, img.shape[0])
    path = _write_png16(tmp_path / "f.png", img, filters)
    np.testing.assert_array_equal(kitti.read_png16(path), img)


@pytest.mark.parametrize("header,message", [(dict(depth=8), "bit depth"),
                                            (dict(colour=3), "colour type"),
                                            (dict(colour=0), "colour type"),
                                            (dict(colour=6), "colour type"),
                                            (dict(interlace=1), "interlaced")])
def test_read_png16_rejects_what_it_does_not_read(tmp_path, header, message):
    img = np.zeros((2, 3, 3), np.uint16)
    path = _write_png16(tmp_path / "f.png", img, **header)
    with pytest.raises(ValueError, match=message):
        kitti.read_png16(path)
    data = bytearray(open(_write_png16(tmp_path / "g.png", img), "rb").read())
    data[40] ^= 1  # a byte of the IDAT chunk
    open(tmp_path / "g.png", "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        kitti.read_png16(str(tmp_path / "g.png"))


# ---------------------------------------------------------------------------
# the compose core
# ---------------------------------------------------------------------------


def _homographies(rng, n, scale=0.02):
    """n homographies (target -> source, normalized) near the planted
    translation."""
    h = np.tile(np.array([[1, 0, 2 * DX_PX / W_IMG], [0, 1, 2 * DY_PX / H_IMG], [0, 0, 1]]),
                (n, 1, 1)) + scale * rng.randn(n, 3, 3)
    h[:, 2, 2] = 1.0
    return h.astype(np.float32)


@pytest.mark.parametrize("out_hw", [(240, 240), (48, 64)])
@pytest.mark.parametrize("cycle_match", [False, True])
@pytest.mark.parametrize("n", [1, 3])
def test_reconstruct_flows_matches_jax(rng, n, cycle_match, out_hw, jx):
    """n homographies in one batch, at HPatches' 240x240 and at 8x the
    stride-8 size (corr's)."""
    coarse_h = _homographies(rng, n)
    flow8 = (0.05 * rng.randn(n, 6, 8, 2)).astype(np.float32)
    match8 = rng.rand(n, 6, 8, 2).astype(np.float32)
    flow, match = compose.reconstruct_flows(coarse_h, flow8, match8, *out_hw, "cpu",
                                            cycle_match=cycle_match)
    flow_r, match_r = jx.compose.reconstruct_flows(coarse_h, flow8, match8, *out_hw,
                                                  cycle_match=cycle_match)
    assert flow.shape == (n, *out_hw, 2) and match.shape == (n, *out_hw)
    np.testing.assert_allclose(flow, flow_r, atol=ATOL_FLOW, rtol=0)
    np.testing.assert_allclose(match, match_r, atol=ATOL_FLOW, rtol=0)


@pytest.mark.parametrize("multi_h,aggregate", [(True, False), (False, False), (True, True)])
def test_merge_multi_h_equals_jax(rng, multi_h, aggregate, jx):
    flows = rng.randn(3, 9, 11, 2).astype(np.float32)
    matches = np.clip(rng.rand(3, 9, 11) * 1.5, 0, 1).astype(np.float32)
    for th in (1.0, 0.5):
        ours = compose.merge_multi_h(flows, matches, th, multi_h, aggregate)
        ref = jx.compose.merge_multi_h(flows, matches, th, multi_h, aggregate)
        assert set(ours) == set(ref)
        for key in ref:
            np.testing.assert_array_equal(ours[key], ref[key])


@pytest.mark.parametrize("cc_th", [0.0, 0.01, 0.2])
def test_remove_small_cc_equals_jax(rng, cc_th, jx):
    match = rng.rand(40, 50).astype(np.float32)
    match[(rng.rand(40, 50) > 0.6)] = 1.0
    match[5:25, 10:40] = 1.0  # one component of 30% of the image
    np.testing.assert_array_equal(compose.remove_small_cc(match.copy(), cc_th),
                                  jx.compose.remove_small_cc(match.copy(), cc_th))


def test_fill_flow_nearest_equals_jax(rng, jx):
    flow = rng.randn(12, 17, 2)
    matched = rng.rand(12, 17) > 0.8
    np.testing.assert_array_equal(compose.fill_flow_nearest(flow, matched),
                                  jx.compose.fill_flow_nearest(flow, matched))


def test_resize_round_stride_equals_jax(rng, jx):
    img = Image.fromarray((rng.rand(75, 248, 3) * 255).astype(np.uint8))
    for size, stride in ((130, 8), (65, 8), (100, 16)):
        np.testing.assert_array_equal(np.asarray(image.resize_round_stride(img, size, stride)),
                                      np.asarray(jx.image.resize_round_stride(img, size, stride)))


def test_kitti_shapes_fit_the_kernels_limits():
    """KITTI at its defaults (a 1242x375 image, coarseSize 800, 3 scales of
    scaleR 1.2, fineSize 650), from the shape rules alone: K2's score under
    2^31 elements, the matches under K3/K4's limit; the fine passes' sizes."""
    cells = lambda wh: (wh[0] // 16) * (wh[1] // 16)  # noqa: E731
    n_b = cells(image.min_size_shape_wh((1242, 375), 800))
    n_a = sum(cells(image.min_size_shape_wh((1242, 375), int(800 * s)))
              for s in image.scale_list(3, 1.2))
    assert n_b == 8250 and n_a == 25747
    assert n_a * n_b < 2**31 and n_b <= MAX_MATCHES
    img = Image.new("RGB", (1242, 375))
    assert image.resize_round_stride(img, 650, 8).size == (2152, 648)
    assert image.resize_round_stride(img, 325, 8).size == (1080, 328)


# ---------------------------------------------------------------------------
# the metric passes on artifacts the JAX package wrote
# ---------------------------------------------------------------------------


def _fine_artifact(rng, n, h8, w8):
    return {
        "coarse_h": _homographies(rng, n),
        "fine_flow_down8": (0.02 * rng.randn(n, h8, w8, 2)).astype(np.float32),
        "fine_match_down8": np.clip(rng.rand(n, h8, w8, 2) * 1.4, 0, 1).astype(np.float32),
        "bg_mask": np.ones((8 * h8, 8 * w8), bool),
    }


def _hpatches_setup(tmp_path, rng, save_pair, pair=None):
    """Three rows (planted and perturbed homographies); artifacts for rows 0
    and 2 written by `save_pair`, row 1 missing."""
    hs_px = [np.array([[1, 0, -DX_PX], [0, 1, -DY_PX], [0, 0, 1]], np.float64)
             + np.round(s * rng.randn(3, 3) * [[1e-3, 1e-3, 1], [1e-3, 1e-3, 1],
                                               [1e-5, 1e-5, 0]], 9)
             for s in (0.0, 1.0, 2.0)]  # DGC-Net's CSVs hold a few digits
    csv_dir, image_dir = _write_hpatches_dataset(tmp_path, rng, hs_px, pair)
    pred_dir = str(tmp_path / "pred")
    for idx, n in ((0, 1), (2, 3)):
        save_pair(os.path.join(pred_dir, "2"), idx,
                              _fine_artifact(rng, n, H_IMG // 8, W_IMG // 8))
    return pred_dir, csv_dir, image_dir


def test_hpatches_gt_grid_equals_jax(tmp_path, rng, jx):
    _, csv_dir, image_dir = _hpatches_setup(tmp_path, rng, jx.artifacts.save_pair)
    path = os.path.join(csv_dir, "hpatches_1_2.csv")
    for row, (_, ref) in zip(table.read_hpatches(path), jx.pd.read_csv(path).iterrows()):
        for size in (240, 37):
            np.testing.assert_array_equal(hpatches.hpatches_gt_grid(row, size, image_dir),
                                          jx.hpatches.hpatches_gt_grid(ref, size, image_dir))


HPATCHES_MODES = [dict(only_coarse=True), dict(), dict(multi_h=False), dict(th=0.5),
                  dict(th=0.5, out_size=160)]


@pytest.mark.parametrize("kw", HPATCHES_MODES)
def test_evaluate_hpatches_matches_jax(tmp_path, rng, kw, jx):
    pred_dir, csv_dir, image_dir = _hpatches_setup(tmp_path, rng, jx.artifacts.save_pair)
    ours, ours_pp = hpatches.evaluate_hpatches(pred_dir, csv_dir, image_dir, "cpu",
                                               scenes=(2,), **kw)
    ref, ref_pp = jx.hpatches.evaluate_hpatches(pred_dir, csv_dir, image_dir, scenes=(2,), **kw)
    np.testing.assert_allclose(ours_pp[2], ref_pp[2], atol=ATOL_PX, rtol=0)
    assert abs(ours[2] - ref[2]) <= ATOL_PX


def _kitti_setup(tmp_path, rng, save_pair):
    """Ground truth for pairs 0-2 (160x160, planted flow); artifacts of the
    KITTI shapes at fineSize 128 for pairs 0 and 2 written by `save_pair`,
    pair 1 missing."""
    gt_dir = tmp_path / "flow_noc"
    os.makedirs(gt_dir)
    for i in range(3):
        _write_png16(gt_dir / f"{i:06}_10.png", _kitti_gt(H_IMG, W_IMG, rng))
    pred_dir = str(tmp_path / "pred")
    for i, n in ((0, 1), (2, 3)):
        art = _fine_artifact(rng, n, 16, 16)
        save_pair(pred_dir, i, art, fine_flow_d2_down8=(
            0.02 * rng.randn(n, 8, 8, 2)).astype(np.float32))
    return pred_dir, str(gt_dir)


KITTI_MODES = [dict(only_coarse=True), dict(), dict(multi_h=False), dict(th=0.5),
               dict(cc_th=0.0), dict(cc_th=0.2, th=0.5), dict(interpolate=True),
               dict(interpolate=True, multi_h=False, th=0.5)]


@pytest.mark.parametrize("kw", KITTI_MODES)
def test_evaluate_kitti_matches_jax(tmp_path, rng, kw, jx):
    pred_dir, gt_dir = _kitti_setup(tmp_path, rng, jx.artifacts.save_pair)
    ours, ours_pp = kitti.evaluate_kitti(pred_dir, gt_dir, "cpu", n_pairs=3, **kw)
    ref, ref_pp = jx.kitti.evaluate_kitti(pred_dir, gt_dir, n_pairs=3, **kw)
    np.testing.assert_allclose(ours_pp, ref_pp, atol=ATOL_PX, rtol=0)
    assert abs(ours - ref) <= ATOL_PX
    art = jx.artifacts.load_pair(pred_dir, 2)
    np.testing.assert_allclose(kitti.compose_kitti_flow(art, H_IMG, W_IMG, "cpu", **kw),
                               jx.kitti.compose_kitti_flow(art, H_IMG, W_IMG, **kw),
                               atol=ATOL_FLOW, rtol=0)


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("dataset", ["MegaDepth", "RobotCar"])
def test_evaluate_corr_equals_jax(tmp_path, rng, dataset, strict, jx):
    """Precision and counts equal: the reference's accounting pair (a
    missing row, two matchability thresholds) and the translation pair
    with points off the image (dropped by MegaDepth, clipped by RobotCar)."""
    csv_path, img_dir, pred_dir, size = _write_corr_accounting_setup(
        tmp_path / "a", rng, jx.artifacts.save_pair)
    kw = dict(dataset=dataset, min_size=size, matchability_th=(0.0, 0.5),
              strict_ref_bug=strict)
    cases = [(pred_dir, csv_path, img_dir, kw)]
    csv_path, img_dir = _write_corr_dataset(tmp_path / "b", rng, n_rows=2, oob=3)
    pred_dir = str(tmp_path / "b" / "pred")
    for idx in range(2):
        jx.artifacts.save_pair(pred_dir, idx, _fine_artifact(rng, 2, 20, 20))
    cases.append((pred_dir, csv_path, img_dir,
                  dict(kw, min_size=H_IMG, matchability_th=(0.0, 0.3, 0.9))))
    for pred, csv, imgs, args in cases:
        ours = corr.evaluate_corr(pred, csv, imgs, "cpu", **args)
        ref = jx.corr.evaluate_corr(pred, csv, imgs, **args)
        assert list(ours) == list(ref)
        for m in ref:
            np.testing.assert_array_equal(ours[m][0], ref[m][0])
            assert ours[m][1] == ref[m][1]


def test_evaluate_corr_raises_as_the_reference(tmp_path, rng):
    csv_path, img_dir, pred_dir, size = _write_corr_accounting_setup(
        tmp_path, rng, artifacts.save_pair)
    with pytest.raises(KeyError):
        corr.evaluate_corr(pred_dir, csv_path, img_dir, "cpu", min_size=size,
                           matchability_th=(0.5,), strict_ref_bug=True)
    with pytest.raises(NameError):
        corr.evaluate_corr(str(tmp_path / "empty"), csv_path, img_dir, "cpu", min_size=size,
                           matchability_th=(0.0, 0.5), strict_ref_bug=True)


# ---------------------------------------------------------------------------
# YFCC: two calibrated views of a curved surface
# ---------------------------------------------------------------------------

YFCC_FOCAL = 120.0  # px, both cameras; the principal point at the image centre
YFCC_TH = 0.95      # the results pass's --th


def _rodrigues(v):
    angle = np.linalg.norm(v)
    k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]]) / angle
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def _yfcc_source_px(u, v, R_b, t_b):
    """The source (camera a) pixel of target (camera b) pixel (u, v): the
    surface's depth in camera b is 4 + 0.8 sin(2 pi u / W) cos(2 pi v / H);
    camera a is the world frame, x_b = R_b x_a + t_b."""
    c = (W_IMG - 1) / 2.0
    z = 4 + 0.8 * np.sin(2 * np.pi * u / W_IMG) * np.cos(2 * np.pi * v / H_IMG)
    X_b = np.stack([(u - c) / YFCC_FOCAL * z, (v - c) / YFCC_FOCAL * z, z], axis=-1)
    X_a = (X_b - t_b) @ R_b
    return YFCC_FOCAL * X_a[..., :2] / X_a[..., 2:] + c


def _yfcc_artifact(rng, angle, R_b, t_b):
    """A pair artifact whose maps live on the target turned by `angle` and
    compose (the identity homography, kernel 8's upsampling) to the
    surface's flow: the residual sampled where the stride-8 cells sit.
    match12 is 1 and match21 in [0.9, 1], so th = 0.95 keeps part of it."""
    h8, w8 = H_IMG // 8, W_IMG // 8
    k = np.arange(h8 * 8).reshape(h8, 8)[:, 0] + 3.5  # centres of the stride-8 cells, px
    py, px = np.meshgrid(k, k, indexing="ij")
    # the original target pixel under each rotated-frame pixel (matches_from_flow)
    s = W_IMG - 1
    u, v = {0: (px, py), 90: (s - py, px), 180: (s - px, s - py), 270: (py, s - px)}[angle]
    src = _yfcc_source_px(u, v, R_b, t_b)
    flow = 2 * src / s - 1 - np.stack([2 * px / s - 1, 2 * py / s - 1], axis=-1)
    match = np.stack([np.ones((h8, w8)), rng.uniform(0.9, 1.0, (h8, w8))], axis=-1)
    bg = np.zeros((H_IMG, W_IMG), bool)
    bg[8:-8, 8:-8] = True
    return {"coarse_h": np.eye(3, dtype=np.float32)[None],
            "fine_flow_down8": flow[None].astype(np.float32),
            "fine_match_down8": match[None].astype(np.float32), "bg_mask": bg}


def _yfcc_setup(tmp_path, rng, save_pair, write_h5=True):
    """A YFCC scene of two 160x160 views and the pairs [0, 1] three times:
    artifacts for pair 0 (rotation 0) and pair 1 (rotation 90) written by
    `save_pair`, pair 2 missing. The calibration .h5 files are written with
    h5py when write_h5 (tests/test_eval.py:439-496). Returns (pred_dir,
    pairs_pkl, scene_dir, calibration records as
    `eval.yfcc.load_scene_calibration` reads them, R_b, t_b)."""
    import pickle

    scene = tmp_path / "scene" / "test"
    os.makedirs(scene)
    img = Image.fromarray((_blocky(rng, H_IMG, W_IMG) * 255).astype(np.uint8))
    for name in ("im0.png", "im1.png"):
        img.save(scene / name)
    (scene / "images.txt").write_text("im0.png\nim1.png\n")
    (scene / "calibration.txt").write_text("calib0.h5\ncalib1.h5\n")
    R_b, t_b = _rodrigues(np.array([0.03, -0.05, 0.02])), np.array([0.6, 0.15, 0.1])
    K = np.array([[YFCC_FOCAL, 0, 0], [0, YFCC_FOCAL, 0], [0, 0, 1.0]])
    calib = [{"R": R, "t": t[:, None], "K": K, "org_size": [W_IMG, H_IMG],
              "resized": (W_IMG, H_IMG)}
             for R, t in ((np.eye(3), np.zeros(3)), (R_b, t_b))]
    if write_h5:
        import h5py

        for name, rec in zip(("calib0.h5", "calib1.h5"), calib):
            with h5py.File(scene / name, "w") as h5:
                h5["R"], h5["T"], h5["K"] = rec["R"], rec["t"].T, rec["K"]
                h5["imsize"] = np.array([[W_IMG, H_IMG]])
    pairs_pkl = tmp_path / "pairs.pkl"
    with open(pairs_pkl, "wb") as f:
        pickle.dump([[0, 1]] * 3, f)
    pred_dir = str(tmp_path / "pred")
    for idx, angle in ((0, 0), (1, 90)):
        save_pair(pred_dir, idx, _yfcc_artifact(rng, angle, R_b, t_b),
                  rotation=np.int32(angle))
    return pred_dir, str(pairs_pkl), str(scene), calib, R_b, t_b


def _record_pose_inputs(monkeypatch, module):
    """Patch module.estimate_pose to record the normalized points it is
    handed, pair by pair; returns the record list."""
    seen = []
    estimate = module.estimate_pose

    def recording(pts1, pts2, *args, **kwargs):
        seen.append((np.array(pts1), np.array(pts2)))
        return estimate(pts1, pts2, *args, **kwargs)

    monkeypatch.setattr(module, "estimate_pose", recording)
    return seen


def _same_points(got, want, near_keys, tol):
    """Two (n1, n2) point sets keyed by their target point n2: equal but for
    the keys in near_keys (a matchability within 1e-6 of th), the source
    points within tol. Returns whether the sets are equal."""
    a = {tuple(k): p for p, k in zip(*got)}
    b = {tuple(k): p for p, k in zip(*want)}
    assert set(a) ^ set(b) <= near_keys
    common = sorted(set(a) & set(b))
    if common:
        np.testing.assert_allclose([a[k] for k in common], [b[k] for k in common],
                                   atol=tol, rtol=0)
    return set(a) == set(b)


def _near_threshold_keys(pred_dir, i, calib, th=YFCC_TH):
    """The normalized target points of pair i whose composed matchability
    lies within 1e-6 of th (either package may keep them)."""
    art = artifacts.load_pair(pred_dir, i)
    flows, matches = compose.reconstruct_flows(
        art["coarse_h"], art["fine_flow_down8"], art["fine_match_down8"], H_IMG, W_IMG, "cpu")
    near = (np.abs(matches[0] - th) <= 1e-6) & art["bg_mask"]
    _, pts2 = yfcc.matches_from_flow(flows[0], near, calib[0]["resized"],
                                     calib[1]["resized"], int(art["rotation"]))
    n2 = yfcc.norm_kp(calib[1]["org_size"], calib[1]["resized"], calib[1]["K"],
                      pts2.astype(np.float64))
    return {tuple(k) for k in n2}


@pytest.mark.parametrize("m", [0.0, 0.4])
def test_pair_precision_hits_equals_jax(rng, m, jx):
    flow = rng.rand(30, 40, 2).astype(np.float32) * 2 - 1
    magg = rng.rand(30, 40).astype(np.float32)
    xs, ys = rng.rand(50) * 60, rng.rand(50) * 45
    xt, yt = rng.rand(50) * 45 - 2, rng.rand(50) * 35 - 2  # a few off the map
    ours = corr.pair_precision_hits(flow, magg, m, xs, ys, xt, yt, 60, 45)
    ref = jx.corr.pair_precision_hits(flow, magg, m, xs, ys, xt, yt, 60, 45)
    np.testing.assert_array_equal(ours[0], ref[0])
    assert ours[1] == ref[1]
    np.testing.assert_array_equal(corr.PIXEL_GRID, jx.corr.PIXEL_GRID)


@pytest.mark.gpu
def test_results_passes_on_card_match_the_cpu(tmp_path, rng, cuda):
    """Kernel 8 on the card against its plain version, through each
    harness's results pass on the same artifacts."""
    img = Image.fromarray((_blocky(rng, H_IMG, W_IMG) * 255).astype(np.uint8))
    pred_dir, csv_dir, image_dir = _hpatches_setup(tmp_path / "h", rng, artifacts.save_pair,
                                                   (img, img))
    for kw in HPATCHES_MODES:
        got = hpatches.evaluate_hpatches(pred_dir, csv_dir, image_dir, cuda, scenes=(2,), **kw)
        want = hpatches.evaluate_hpatches(pred_dir, csv_dir, image_dir, "cpu", scenes=(2,), **kw)
        np.testing.assert_allclose(got[1][2], want[1][2], atol=1e-3, rtol=0)
    pred_dir, gt_dir = _kitti_setup(tmp_path / "k", rng, artifacts.save_pair)
    for kw in KITTI_MODES:
        got = kitti.evaluate_kitti(pred_dir, gt_dir, cuda, n_pairs=3, **kw)
        want = kitti.evaluate_kitti(pred_dir, gt_dir, "cpu", n_pairs=3, **kw)
        np.testing.assert_allclose(got[1], want[1], atol=1e-3, rtol=0)
    csv_path, img_dir, pred_dir, size = _write_corr_accounting_setup(tmp_path / "c", rng,
                                                                     artifacts.save_pair)
    got = corr.evaluate_corr(pred_dir, csv_path, img_dir, cuda, min_size=size,
                             matchability_th=(0.0, 0.5))
    want = corr.evaluate_corr(pred_dir, csv_path, img_dir, "cpu", min_size=size,
                              matchability_th=(0.0, 0.5))
    for m in want:
        np.testing.assert_array_equal(got[m][0], want[m][0])
        assert got[m][1] == want[m][1]


@pytest.mark.gpu
def test_yfcc_results_pass_on_card_matches_the_cpu(tmp_path, rng, cuda, monkeypatch):
    """YFCC's results pass on the card (kernel 8, the pose hypotheses scored
    there) against the CPU on the same artifacts and seed: the point sets
    equal but at pixels within 1e-6 of th, and where they are equal, the
    same pose errors: equal on points equal bit for bit, else within a
    degree (kernel 8's last bits move a point, and RANSAC may then keep
    another model)."""
    pred_dir, pairs_pkl, scene, calib, _, _ = _yfcc_setup(tmp_path, rng, artifacts.save_pair,
                                                          write_h5=False)
    seen = _record_pose_inputs(monkeypatch, yfcc)
    got = yfcc.evaluate_yfcc(pred_dir, pairs_pkl, scene, cuda, calibration=calib)
    want = yfcc.evaluate_yfcc(pred_dir, pairs_pkl, scene, "cpu", calibration=calib)
    for i in range(2):
        if _same_points(seen[i], seen[2 + i], _near_threshold_keys(pred_dir, i, calib),
                        1e-5 * (W_IMG - 1) / 2 / YFCC_FOCAL):
            if np.array_equal(seen[i][0], seen[2 + i][0]):
                assert got[0][i] == want[0][i]
            else:
                assert abs(got[0][i] - want[0][i]) <= 1.0
    assert got[0][2] == want[0][2] == 180.0
