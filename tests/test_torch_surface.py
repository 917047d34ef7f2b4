"""Parity of the port's API surface outside the main paths with the JAX
package, on the CPU: the grid indices, the Hough and translation fits,
saliency, 1-D blur-pool, the reference-API heads, the monitor's images,
timer and profiler trace, `save_params_npz` / `state_dict_to_tree`, the
subpackages' exports and the synthetic demo.

Inputs come from numpy seeds; networks carry the JAX init trees across with
`tree_to_state_dict` (BatchNorm statistics moved off identity first).
"""

import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import ransacflow_tpu.models as jmodels
import ransacflow_tpu.ops as jops
import ransacflow_tpu.utils as jutils
from ransacflow_tpu.models import convert as jconvert
from ransacflow_tpu.models import heads as jheads
from ransacflow_tpu.models.resnet50 import init_resnet50_layer3 as j_init_resnet
from ransacflow_tpu.ops import blurpool as jblur
from ransacflow_tpu.ops import grid as jgrid
from ransacflow_tpu.ops import homography as jhomography
from ransacflow_tpu.ops import ransac as jransac
from ransacflow_tpu.ops import saliency as jsaliency
from ransacflow_tpu.pipeline import RansacFlowAligner as JRansacFlowAligner
from ransacflow_tpu.pipeline import coarse as jcoarse
from ransacflow_tpu.pipeline import init_alignment_params as j_init_align
from ransacflow_tpu.utils import monitor as jmonitor
import ransacflow_tpu_torch.models as tmodels
import ransacflow_tpu_torch.ops as tops
import ransacflow_tpu_torch.utils as tutils
from ransacflow_tpu_torch import native
from ransacflow_tpu_torch.examples import synthetic_demo
from ransacflow_tpu_torch.models import convert, heads
from ransacflow_tpu_torch.ops import blurpool, grid, homography, saliency
from ransacflow_tpu_torch.pipeline import coarse
from ransacflow_tpu_torch.pipeline.api import RansacFlowAligner
from ransacflow_tpu_torch.utils import monitor

HEADS_ATOL = 2e-4  # tests/test_torch_models.py::test_heads


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np_tree(tree, rng):
    """The tree as numpy, with BN statistics and affine moved off identity."""
    out = {k: _np_tree(v, rng) if isinstance(v, dict) else np.asarray(v, np.float32)
           for k, v in tree.items()}
    if "running_mean" in out:
        c = out["running_mean"].shape[0]
        out["running_mean"] = (0.1 * rng.randn(c)).astype(np.float32)
        out["running_var"] = (0.75 + 0.5 * rng.rand(c)).astype(np.float32)
        out["weight"] = (1 + 0.1 * rng.randn(c)).astype(np.float32)
        out["bias"] = (0.1 * rng.randn(c)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def align_tree():
    return _np_tree(j_init_align(jax.random.PRNGKey(1)), np.random.RandomState(5))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _leaves(tree, prefix=()):
    """{path tuple: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


# -- ops ----------------------------------------------------------------------


@pytest.mark.parametrize("h,w", [(1, 1), (3, 5), (6, 4)])
def test_feature_cell_indices(h, w):
    rows, cols = grid.feature_cell_indices(h, w, "cpu")
    jrows, jcols = jgrid.feature_cell_indices(h, w)
    assert rows.dtype == cols.dtype == torch.int64
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jcols))


def _point_sets(rng, lead, n, dim):
    """(lead..., n, dim) points in [-1, 1]; homogeneous when dim is 3."""
    p = rng.uniform(-1, 1, (*lead, n, 2)).astype(np.float32)
    if dim == 3:
        p = np.concatenate([p, np.ones((*lead, n, 1), np.float32)], axis=-1)
    return p


@pytest.mark.parametrize("dim", [2, 3])
def test_fit_translation_exact(dim):
    rng = np.random.RandomState(1)
    X, Y = _point_sets(rng, (2, 3), 5, dim), _point_sets(rng, (2, 3), 5, dim)
    got = homography.fit_translation(_t(X), _t(Y))
    assert got.shape == (2, 3, 3, 3)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jhomography.fit_translation(X, Y)))


@pytest.mark.parametrize("lead,n,dim", [((), 4, 2), ((3,), 12, 3), ((2, 2), 40, 2)])
def test_fit_hough(lead, n, dim):
    rng = np.random.RandomState(2)
    Y = _point_sets(rng, lead, n, dim)
    # X = a per-axis scale and shift of Y plus noise: a well-posed fit
    X = Y.copy()
    X[..., 0] = 1.2 * Y[..., 0] + 0.1 + 0.01 * rng.randn(*lead, n)
    X[..., 1] = 0.8 * Y[..., 1] - 0.2 + 0.01 * rng.randn(*lead, n)
    got = homography.fit_hough(_t(X), _t(Y))
    assert got.shape == (*lead, 3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jhomography.fit_hough(X, Y)),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(1, 2, 2, 4), (2, 5, 7, 16)])
def test_saliency_coef(shape):
    rng = np.random.RandomState(3)
    feat = rng.randn(*shape).astype(np.float32)
    feat /= np.linalg.norm(feat, axis=-1, keepdims=True)
    got = saliency.saliency_coef(_t(feat))
    assert got.shape == (*shape[:3], 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jsaliency.saliency_coef(feat)),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("filt_size", [2, 3, 4, 5])
@pytest.mark.parametrize("length", [10, 11])
def test_blur_pool_1d(filt_size, length):
    x = np.random.RandomState(4).randn(2, length, 3).astype(np.float32)
    got = blurpool.blur_pool_1d(_t(x), filt_size)
    want = np.asarray(jblur.blur_pool_1d(jnp.asarray(x), filt_size))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


# -- the reference-API heads ---------------------------------------------------


def _heads_inputs(up8, b=2, h=5, w=6):
    rng = np.random.RandomState(6)
    corr = rng.rand(b, h, w, 49).astype(np.float32)
    s = 8 if up8 else 1
    g = rng.uniform(-1.1, 1.1, (b, h * s, w * s, 2)).astype(np.float32)
    return corr, g


def _bn_stats(net):
    return {f"bn{i}": {"running_mean": getattr(net, f"bn{i}").running_mean,
                       "running_var": getattr(net, f"bn{i}").running_var} for i in (1, 2, 3)}


def _close_stats(net, jstats):
    for bn, stats in _bn_stats(net).items():
        for key, val in stats.items():
            np.testing.assert_allclose(val.numpy(), np.asarray(jstats[bn][key]), atol=1e-5,
                                       rtol=1e-5)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("up8", [False, True])
def test_pred_flow_coarse(align_tree, up8, train):
    nets = convert.alignment_params_from_tree(align_tree, "cpu")
    net = nets["netFlowCoarse"].train(train)
    corr, g = _heads_inputs(up8)
    jmag, jgrid_, jstats = jheads.pred_flow_coarse(align_tree["netFlowCoarse"],
                                                   jnp.asarray(corr), jnp.asarray(g), up8,
                                                   train=train)
    mag, out_grid = heads.pred_flow_coarse(net, _t(corr), _t(g), up8)
    np.testing.assert_allclose(mag.detach().numpy(), np.asarray(jmag), atol=HEADS_ATOL)
    np.testing.assert_allclose(out_grid.detach().numpy(), np.asarray(jgrid_), atol=HEADS_ATOL)
    if train:
        _close_stats(net, jstats)
    else:
        assert jstats == {}


@pytest.mark.parametrize("up8", [False, True])
def test_pred_flow_coarse_no_grad(align_tree, up8):
    net = convert.alignment_params_from_tree(align_tree, "cpu")["netFlowCoarse"]
    corr, g = _heads_inputs(up8)
    want = jheads.pred_flow_coarse_no_grad(align_tree["netFlowCoarse"], jnp.asarray(corr),
                                           jnp.asarray(g), up8)
    c = _t(corr).requires_grad_()
    got = heads.pred_flow_coarse_no_grad(net, c, _t(g), up8)
    assert got.grad_fn is None and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=HEADS_ATOL)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("up8", [False, True])
def test_pred_matchability(align_tree, up8, train):
    net = convert.alignment_params_from_tree(align_tree, "cpu")["netMatch"].train(train)
    corr, _ = _heads_inputs(up8)
    want, jstats = jheads.pred_matchability(align_tree["netMatch"], jnp.asarray(corr), up8,
                                            train=train)
    got = heads.pred_matchability(net, _t(corr), up8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=HEADS_ATOL)
    if train:
        _close_stats(net, jstats)


def test_pred_flow_coarse_input_gradient(align_tree):
    """The gradient of a weighted sum of both outputs to the correlation,
    against `jax.vjp` of the JAX function (eval mode)."""
    net = convert.alignment_params_from_tree(align_tree, "cpu")["netFlowCoarse"]
    corr, g = _heads_inputs(True)
    rng = np.random.RandomState(7)
    jout = jheads.pred_flow_coarse(align_tree["netFlowCoarse"], jnp.asarray(corr),
                                   jnp.asarray(g))[:2]
    cot = [rng.randn(*o.shape).astype(np.float32) for o in jout]

    def f(c):
        return jheads.pred_flow_coarse(align_tree["netFlowCoarse"], c, jnp.asarray(g))[:2]

    _, vjp = jax.vjp(f, jnp.asarray(corr))
    (want,) = vjp(tuple(jnp.asarray(c) for c in cot))
    c = _t(corr).requires_grad_()
    outs = heads.pred_flow_coarse(net, c, _t(g))
    (got,) = torch.autograd.grad(outs, [c], [_t(x) for x in cot])
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=HEADS_ATOL * scale, rtol=0)


# -- monitor ---------------------------------------------------------------------


def _monitor_inputs():
    rng = np.random.RandomState(8)
    return {"map_b": rng.rand(2, 6, 7, 1).astype(np.float32) * 1.4 - 0.2,
            "map_hw": rng.rand(6, 7).astype(np.float32),
            "rgb": rng.rand(6, 7, 3).astype(np.float32) * 1.2 - 0.1,
            "flow": rng.randn(1, 6, 7, 2).astype(np.float32) * 0.1,
            "flow_hw": rng.randn(6, 7, 2).astype(np.float32)}


@pytest.mark.parametrize("name", ["map_b", "map_hw", "rgb"])
def test_tensor2image(name):
    arr = _monitor_inputs()[name]
    want = jmonitor.tensor2image(arr)
    for x in (arr, _t(arr)):
        got = monitor.tensor2image(x)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    pil = Image.fromarray(want)
    np.testing.assert_array_equal(monitor.tensor2image(pil), jmonitor.tensor2image(pil))


@pytest.mark.parametrize("name", ["flow", "flow_hw"])
def test_flow2image(name):
    arr = _monitor_inputs()[name]
    want = jmonitor.flow2image(arr)
    for x in (arr, _t(arr)):
        got = monitor.flow2image(x)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_log_image_paths(tmp_path):
    ins = _monitor_inputs()
    ours = monitor.MetricsLogger(str(tmp_path / "port"), echo=False)
    ref = jmonitor.MetricsLogger(str(tmp_path / "jax"), echo=False)
    for step, (name, kind) in enumerate([("map_b", "auto"), ("flow", "flow")]):
        p = ours.log_image(step, name, _t(ins[name]), kind=kind)
        q = ref.log_image(step, name, ins[name], kind=kind)
        assert os.path.relpath(p, tmp_path / "port") == os.path.relpath(q, tmp_path / "jax")
        np.testing.assert_array_equal(np.asarray(Image.open(p)), np.asarray(Image.open(q)))
    assert sorted(os.listdir(tmp_path / "port" / "images")) == \
        sorted(os.listdir(tmp_path / "jax" / "images"))


def test_stage_timer_report():
    totals = {"coarse": 1.23456, "fine": 0.5, "io": 2.0}
    counts = {"coarse": 3, "fine": 7, "io": 1}
    ours, ref = monitor.StageTimer(), jmonitor.StageTimer()
    for t in (ours, ref):
        t.totals, t.counts = dict(totals), dict(counts)
    assert ours.report() == ref.report()
    timer = monitor.StageTimer()
    for _ in range(2):
        with timer.time("stage"):
            pass
    assert re.fullmatch(r"stage: total \d+\.\d{3}s, 2 calls, \d+\.\d ms/call", timer.report())


def test_profile_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with monitor.profile_trace(str(log_dir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1 and os.path.getsize(log_dir / files[0]) > 0
    off = tmp_path / "off"
    with monitor.profile_trace(str(off), enabled=False):
        torch.ones(4) + 1
    assert not off.exists()


# -- convert ---------------------------------------------------------------------


def test_save_params_npz_matches_jax(tmp_path, align_tree):
    nets = convert.alignment_params_from_tree(align_tree, "cpu")
    convert.save_params_npz(tmp_path / "port.npz", nets)
    jconvert.save_params_npz(tmp_path / "jax.npz", align_tree)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            assert a[key].dtype == b[key].dtype == np.float16, key
            np.testing.assert_array_equal(a[key], b[key])


def test_jax_reads_the_ports_npz(tmp_path, align_tree):
    """JAX's `load_params_npz` of the port's file gives heads that compute
    what the port's heads of the same file compute."""
    path = tmp_path / "weights.npz"
    convert.save_params_npz(path, convert.alignment_params_from_tree(align_tree, "cpu"))
    jtree = jconvert.load_params_npz(path, dtype=jnp.float32)
    nets = convert.alignment_params_from_tree(convert.load_params_npz(path), "cpu")
    corr = np.random.RandomState(9).rand(1, 5, 6, 49).astype(np.float32)
    want, _ = jheads.net_flow_coarse(jtree["netFlowCoarse"], jnp.asarray(corr))
    with torch.no_grad():
        got = heads.net_flow_coarse(nets["netFlowCoarse"], _t(corr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=HEADS_ATOL)
    want, _ = jheads.net_matchability(jtree["netMatch"], jnp.asarray(corr))
    with torch.no_grad():
        got = heads.net_matchability(nets["netMatch"], _t(corr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=HEADS_ATOL)


@pytest.mark.parametrize("net", ["netFeatCoarse", "netFlowCoarse", "netMatch", "resnet"])
def test_state_dict_to_tree_inverts_tree_to_state_dict(align_tree, net):
    tree = (_np_tree(j_init_resnet(jax.random.PRNGKey(0)), np.random.RandomState(5))
            if net == "resnet" else align_tree[net])
    sd = convert.tree_to_state_dict(tree)
    back = convert.state_dict_to_tree(sd)
    want, got = _leaves(tree), _leaves(back)
    assert sorted(got) == sorted(want)
    for key, leaf in want.items():
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], leaf)
    # JAX's converter on the same state_dict (`module.` prefixes and a
    # skipped prefix included) agrees leaf by leaf
    sd = {"module." + k: v for k, v in sd.items()}
    jtree = jconvert.state_dict_to_tree({k: v.numpy() for k, v in sd.items()},
                                        skip_prefixes=("layer1.",))
    got = _leaves(convert.state_dict_to_tree(sd, skip_prefixes=("layer1.",)))
    want = _leaves(jtree)
    assert sorted(got) == sorted(want)
    for key, leaf in want.items():
        np.testing.assert_array_equal(got[key], leaf)


def test_load_torch_checkpoint_is_weights_only(tmp_path):
    torch.save({"a": torch.ones(2)}, tmp_path / "ok.pth")
    assert torch.equal(convert.load_torch_checkpoint(str(tmp_path / "ok.pth"))["a"],
                       torch.ones(2))
    torch.save({"a": types.SimpleNamespace(x=1)}, tmp_path / "code.pth")
    with pytest.raises(Exception, match="[Ww]eights only"):
        convert.load_torch_checkpoint(str(tmp_path / "code.pth"))


def test_native_available_is_a_predicate(monkeypatch):
    def fail():
        raise RuntimeError("no g++")

    monkeypatch.setattr(native, "library", fail)
    assert native.native_available() is False
    monkeypatch.setattr(native, "library", lambda: object())
    assert native.native_available() is True


# -- exports ---------------------------------------------------------------------

# JAX-exported names with no meaning in PyTorch: tree builders and the
# BatchNorm-statistics merge, which the port's modules replace
NO_MEANING = {"init_feature_extractor", "init_net_flow_coarse", "init_net_matchability",
              "init_segnet_encoder", "init_segnet_decoder", "merge_bn_stats"}


@pytest.mark.parametrize("jpkg,tpkg", [(jops, tops), (jmodels, tmodels), (jutils, tutils)],
                         ids=["ops", "models", "utils"])
def test_subpackage_exports(jpkg, tpkg):
    names = [n for n, v in vars(jpkg).items()
             if not n.startswith("_") and not isinstance(v, types.ModuleType)]
    assert names
    missing = [n for n in names if n not in NO_MEANING and not hasattr(tpkg, n)]
    assert not missing, missing


# -- the synthetic demo ------------------------------------------------------------


def test_synthetic_demo_recovers_the_translation(tmp_path):
    s = 256
    h_est, err_px = synthetic_demo.main(["--device", "cpu", "--outdir", str(tmp_path)])
    assert h_est is not None and h_est.shape == (3, 3)
    # tests/test_pipeline.py::test_coarse_aligner_recovers_translation's bound
    assert err_px * 2 / (s - 1) < 0.02
    for name in ("before.png", "after_coarse.png", "after_fine.png"):
        img = np.asarray(Image.open(tmp_path / name))
        assert img.shape == (s, s, 3) and img.dtype == np.uint8, name


def _demo_case():
    """The demo's pair as PIL images, its border mask, h_true, and JAX's
    demo weights (`init_alignment_params(PRNGKey(0))`,
    `init_resnet50_layer3(PRNGKey(1))`) with the port's networks carrying
    them."""
    s = 256
    src_arr, tgt_arr, h_true = synthetic_demo.translated_pair(s, "cpu")
    src = Image.fromarray((src_arr * 255).astype(np.uint8))
    tgt = Image.fromarray((np.clip(tgt_arr, 0, 1) * 255).astype(np.uint8))
    border = np.ones((s, s), np.float32)
    border[s // 5: -s // 5, s // 5: -s // 5] = 0
    ja, jr = j_init_align(jax.random.PRNGKey(0)), j_init_resnet(jax.random.PRNGKey(1))
    align = convert.alignment_params_from_tree(jax.tree.map(np.asarray, ja), "cpu")
    resnet = convert.resnet50_layer3_from_tree(jax.tree.map(np.asarray, jr), "cpu")
    return src, tgt, border, h_true, (ja, jr), (align, resnet)


def _record_masks(monkeypatch):
    """{'jax': mask, 'port': mask}: the inlier cells of each package's last
    `CoarseAligner.get_coarse`."""
    masks = {}
    for key, cls in (("jax", jcoarse.CoarseAligner), ("port", coarse.CoarseAligner)):
        def get_coarse(self, *a, _fn=cls.get_coarse, _key=key, **kw):
            H, inlier = _fn(self, *a, **kw)
            masks[_key] = inlier
            return H, inlier

        monkeypatch.setattr(cls, "get_coarse", get_coarse)
    return masks


def _replay_draws(monkeypatch):
    """Record JAX's fixed-count draws (its valid-first order at the drawn
    ranks) and replay them in the port's CoarseAligner."""
    recorded = []
    j_ransac, t_ransac = jcoarse.ransac_homography, coarse.ransac_homography

    def recording(key, m1, m2, valid, tolerance, n_iter=10000, **kw):
        raw, _ = jransac._sample_minimal_sets(key, jnp.sum(valid.astype(jnp.int32)), 4,
                                              n_iter)
        recorded.append(np.asarray(jnp.argsort(~valid, stable=True)[raw]).astype(np.int32))
        return j_ransac(key, m1, m2, valid, tolerance, n_iter=n_iter, **kw)

    def replaying(m1, m2, valid, tolerance, n_iter=10000, generator=None):
        return t_ransac(m1, m2, valid, tolerance, n_iter=n_iter,
                        injected_samples=_t(recorded.pop(0)))

    monkeypatch.setattr(jcoarse, "ransac_homography", recording)
    monkeypatch.setattr(coarse, "ransac_homography", replaying)
    return recorded


DEMO_KW = dict(nb_scale=1, n_iter=3000, min_size=256, resize_mode="min")


def _h_error(h, h_true):
    pts = _t(np.random.RandomState(1).rand(64, 2).astype(np.float32) * 1.2 - 0.6)
    a = homography.apply_homography(_t((h / h[2, 2]).astype(np.float32)), pts).numpy()
    return float(np.abs(a - homography.apply_homography(_t(h_true), pts).numpy()).mean())


def test_demo_aligner_matches_jax(monkeypatch):
    """The demo's aligner on JAX's demo weights against JAX's aligner on the
    same pair, under JAX's draws: equal inlier masks, H21 within 1e-5 and
    the fine stage's maps."""
    src, tgt, border, h_true, (ja, jr), (align, resnet) = _demo_case()
    masks = _record_masks(monkeypatch)
    recorded = _replay_draws(monkeypatch)
    ref = JRansacFlowAligner(ja, jr, **DEMO_KW).align_images(src, tgt, exclusion_mask=border)
    out = RansacFlowAligner(align, resnet, "cpu", **DEMO_KW).align_images(
        src, tgt, exclusion_mask=border)
    assert not recorded  # the one fit replayed
    np.testing.assert_array_equal(masks["port"], np.asarray(masks["jax"]))
    np.testing.assert_allclose(out["H21"], np.asarray(ref["H21"]), atol=1e-5, rtol=0)
    assert _h_error(out["H21"], h_true) < 0.02
    for key in ("flow", "match", "warped_coarse", "warped_fine", "target"):
        np.testing.assert_allclose(out[key], np.asarray(ref[key]), atol=1e-3, err_msg=key)


def test_demo_aligner_own_draws(monkeypatch):
    """Each package draws its own RANSAC sets: both find the planted
    translation's inlier cells. H21 is not held here: the host's fp64
    polish re-solves the winning set with the SVD, and a winning set with
    three collinear cells (the port's first draw here) leaves a rank-7
    system whose null space is two-dimensional, in both packages
    (`test_polish_of_a_set_with_three_collinear_cells`)."""
    src, tgt, border, _, (ja, jr), (align, resnet) = _demo_case()
    masks = _record_masks(monkeypatch)
    ref = JRansacFlowAligner(ja, jr, **DEMO_KW).align_images(src, tgt, exclusion_mask=border)
    out = RansacFlowAligner(align, resnet, "cpu", **DEMO_KW).align_images(
        src, tgt, exclusion_mask=border)
    assert ref["H21"] is not None and out["H21"] is not None
    assert masks["port"].sum() >= 20
    np.testing.assert_array_equal(masks["port"], np.asarray(masks["jax"]))


def test_polish_of_a_set_with_three_collinear_cells():
    """The demo's winning set under the port's draws (cells 1, 2 and 3 on
    one line): the closed form of the RANSAC kernel and its twin gives the
    translation, the fp64 SVD re-solve of both packages another matrix of
    the null space, the same in both."""
    X = np.array([[0.5625, 0.3125], [0.1875, 0.3125], [-0.1875, 0.0625], [0.5625, 0.5625]],
                 np.float32)
    Y = X - np.float32(0.125)
    h_true = np.array([[1, 0, 0.125], [0, 1, 0.125], [0, 0, 1]], np.float32)
    closed = homography.dlt_homography(_t(X), _t(Y)).numpy()
    assert _h_error(closed, h_true) < 1e-6
    polished = homography.dlt_homography_np(X, Y)
    np.testing.assert_array_equal(polished, jhomography.dlt_homography_np(X, Y))
    assert _h_error(polished, h_true) > 0.1
