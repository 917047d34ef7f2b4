"""`refine_flow_ransac` of the PyTorch port against the JAX package's, on the
CPU: the four cases of tests/test_refine.py and one past the RANSAC kernels'
shared-memory order (40,960 matches).

Both sides fit the same minimal sets: JAX's `ransac_homography` inside its
refine module is wrapped to take the port's Philox draws of the gated
pixels as `injected_samples`, and the port is handed the same sets. The
alignment networks are JAX's init tree with netFlowCoarse.conv4 zeroed (the
zero-flow trick of tests/test_validation.py: the re-run fine stage then
reproduces the refined coarse grid), carried over by `convert`.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ransacflow_tpu.ops.homography import warp_grid as j_warp_grid
from ransacflow_tpu.pipeline import init_alignment_params as j_init_align
from ransacflow_tpu.pipeline import refine as jrefine
from ransacflow_tpu.pipeline.fine import fine_features as j_fine_features
from ransacflow_tpu_torch.kernels.ransac import draw_sets_ref
from ransacflow_tpu_torch.models import convert
from ransacflow_tpu_torch.ops.homography import warp_grid
from ransacflow_tpu_torch.pipeline import fine_features, refine_flow_ransac

HT, WT = 48, 64
H_GT = np.array([[0.9, 0.05, 0.02], [-0.03, 0.85, -0.05], [0.01, -0.02, 1.0]], np.float32)
ATOL_H = 1e-5     # the refined transform, normalized by its [2, 2]
ATOL_FINE = 1e-5  # the re-run fine stage's outputs


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    params = j_init_align(jax.random.PRNGKey(0))
    conv4 = params["netFlowCoarse"]["conv4"]["weight"]
    params["netFlowCoarse"]["conv4"]["weight"] = jnp.zeros_like(conv4)
    nets = convert.alignment_params_from_tree(params, "cpu")
    return params, nets


def _images(shape, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.rand(1, *shape, 3).astype(np.float32),
            rng.rand(1, *shape, 3).astype(np.float32))


def _norm(h):
    h = np.asarray(h, np.float64)
    return h / h[2, 2]


def _both(setup, monkeypatch, flow, match, shape=(HT, WT), seed=0, **kw):
    """Both packages' refine on the same inputs and the same minimal sets:
    the port's draws of JAX's gated pixels under `seed`."""
    params, nets = setup
    src, tgt = _images(shape)
    sets = []
    j_ransac = jrefine.ransac_homography

    def injecting(key, m1, m2, valid, tolerance, n_iter=10000, n_points=4, **rkw):
        sets.append(draw_sets_ref(t(np.asarray(valid)), torch.tensor([seed]), n_iter,
                                  n_points=n_points))
        return j_ransac(key, m1, m2, valid, tolerance, n_iter=n_iter, n_points=n_points,
                        injected_samples=jnp.asarray(sets[-1].numpy()), **rkw)

    monkeypatch.setattr(jrefine, "ransac_homography", injecting)
    ref = jrefine.refine_flow_ransac(
        jax.random.PRNGKey(0), params, jnp.asarray(src),
        j_fine_features(params, jnp.asarray(tgt)), jnp.asarray(flow), jnp.asarray(match),
        **kw)
    out = refine_flow_ransac(None, nets, t(src), fine_features(nets, t(tgt)), t(flow),
                             t(match), injected_samples=sets[0], **kw)
    return out, ref


def _assert_matches(out, ref):
    assert bool(out["found"]) == bool(ref["found"])
    assert int(out["num_inliers"]) == int(ref["num_inliers"])
    np.testing.assert_allclose(_norm(out["refined_h"]), _norm(ref["refined_h"]), atol=ATOL_H)
    for key in ("flow", "match", "flow_down8", "match_down8"):
        assert tuple(out[key].shape) == tuple(ref[key].shape), key
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=ATOL_FINE,
                                   err_msg=key)


def _planted_flow(h, shape=(HT, WT)):
    return np.array(j_warp_grid(jnp.asarray(h)[None], *shape))


def test_refine_recovers_homography_with_outliers(setup, monkeypatch):
    """A corrupted but matched block is rejected; the homography recovered;
    the zero-flow fine stage reproduces the refined grid."""
    flow = _planted_flow(H_GT)
    flow[0, 10:26, 20:44] += 0.4
    out, ref = _both(setup, monkeypatch, flow, np.ones((HT, WT), np.float32), n_iter=300)
    _assert_matches(out, ref)
    assert bool(out["found"])
    np.testing.assert_allclose(_norm(out["refined_h"]), _norm(H_GT), atol=1e-3)
    assert int(out["num_inliers"]) > 0.9 * (HT * WT - 16 * 24)
    grid = warp_grid(out["refined_h"][None], HT, WT)
    np.testing.assert_allclose(out["flow"].numpy(), grid.numpy(), atol=5e-3)


def test_refine_identity_fallback_when_unmatched(setup, monkeypatch):
    out, ref = _both(setup, monkeypatch, _planted_flow(H_GT),
                     np.zeros((HT, WT), np.float32), n_iter=64)
    _assert_matches(out, ref)
    assert not bool(out["found"])
    np.testing.assert_array_equal(out["refined_h"].numpy(), np.eye(3, dtype=np.float32))


def test_refine_affine_mode(setup, monkeypatch):
    theta = np.array([[0.8, 0.1, 0.05], [-0.05, 0.9, -0.1]], np.float32)
    h_aff = np.vstack([theta, [0.0, 0.0, 1.0]]).astype(np.float32)
    flow = _planted_flow(h_aff)
    out, ref = _both(setup, monkeypatch, flow, np.ones((HT, WT), np.float32), seed=1,
                     transform="affine", n_iter=64, n_points=3)
    _assert_matches(out, ref)
    assert bool(out["found"])
    np.testing.assert_allclose(out["refined_h"].numpy(), h_aff, atol=0.02)
    refit = warp_grid(out["refined_h"][None], HT, WT).numpy()
    assert np.abs(refit - flow).max() < 0.03


def test_refine_out_of_bounds_flow_excluded(setup, monkeypatch):
    flow = _planted_flow(H_GT)
    flow[0, :, :WT // 2] = 5.0
    out, ref = _both(setup, monkeypatch, flow, np.ones((HT, WT), np.float32), seed=2,
                     n_iter=300)
    _assert_matches(out, ref)
    assert bool(out["found"])
    np.testing.assert_allclose(_norm(out["refined_h"]), _norm(H_GT), atol=1e-3)


def test_refine_past_the_shared_order_matches_jax(setup, monkeypatch):
    """192 x 256 = 49,152 pixels, past the kernels' 40,960-match shared
    order: the plain path against JAX on the same sets, affine and
    homography."""
    shape = (192, 256)
    flow = _planted_flow(H_GT, shape)
    flow[0, 40:90, 60:150] += 0.3
    match = np.ones(shape, np.float32)
    match[:, :8] = 0.2
    out, ref = _both(setup, monkeypatch, flow, match, shape=shape, seed=4, n_iter=200)
    _assert_matches(out, ref)
    assert bool(out["found"]) and int(out["num_inliers"]) > 0.8 * 192 * 248 - 50 * 90


def test_refine_draws_from_the_generator(setup):
    """Without injected sets the port draws from its generator: the same
    seed gives the same fit, and the homography is recovered."""
    _, nets = setup
    src, tgt = (t(a) for a in _images((HT, WT)))
    featt = fine_features(nets, tgt)
    flow = t(_planted_flow(H_GT))
    match = torch.ones((HT, WT))
    outs = [refine_flow_ransac(torch.Generator().manual_seed(9), nets, src, featt, flow, match,
                               n_iter=200) for _ in range(2)]
    assert torch.equal(outs[0]["refined_h"], outs[1]["refined_h"])
    np.testing.assert_allclose(_norm(outs[0]["refined_h"]), _norm(H_GT), atol=1e-3)
