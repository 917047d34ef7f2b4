"""Affine fits in the PyTorch port against the JAX package, on the CPU, and,
on the card, the affine and large-N forms of kernels 3 and 4 against their
plain versions.

`fit_affine` and `affine_grid` are held to JAX's; affine RANSAC (3-point
sets, no |det| gate) to JAX's under the same injected sets, fixed-count and
adaptive (JAX's per-block draws replayed); `CoarseAligner(transform=
'affine')` and the multi-homography loops on the translated pair of
tests/test_torch_multihomo.py. Weights are JAX's init trees, carried over
by `convert`.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from ransacflow_tpu.ops import ransac as jransac
from ransacflow_tpu.ops.homography import fit_affine as j_fit_affine
from ransacflow_tpu.ops.sampler import affine_grid as j_affine_grid
from ransacflow_tpu.pipeline import coarse as jcoarse
from ransacflow_tpu.pipeline import multihomo as jmultihomo
from ransacflow_tpu_torch import kernels
from ransacflow_tpu_torch.kernels.ransac import (
    MAX_MATCHES,
    boundary_flips,
    draw_sets_ref,
    ransac_fit,
    ransac_fit_ref,
    ransac_score_ref,
)
from ransacflow_tpu_torch.kernels.ransac_adaptive import ransac_adaptive, ransac_adaptive_ref
from ransacflow_tpu_torch.ops import ransac
from ransacflow_tpu_torch.ops.homography import fit_affine, reprojection_error
from ransacflow_tpu_torch.ops.sampler import affine_grid
from ransacflow_tpu_torch.pipeline import coarse, multihomo
from test_torch_multihomo import (  # noqa: F401  (the module's fixtures)
    N_ITER,
    _aligners,
    _border_mask,
    _h_error,
    _loop_inputs,
    _translated_pair,
    nets,
)

TOL = 0.05
ATOL_H21 = 1e-5  # the 3-point solve: JAX's LU against the port's closed form
A_TRUE = np.array([[0.9, 0.1, 0.05], [-0.05, 0.85, -0.1], [0.0, 0.0, 1.0]], np.float32)


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def t(a):
    return torch.from_numpy(np.array(a))


def _seed(value):
    return torch.tensor([value], dtype=torch.int64)


def _affine_problem(rng, n=300, inlier_frac=0.7, noise=0.003, valid_frac=1.0):
    """match1, match2 (n, 3) float32 of A_TRUE with outliers, and valid."""
    m2 = np.concatenate([rng.rand(n, 2) * 1.6 - 0.8, np.ones((n, 1))], 1).astype(np.float32)
    m1 = m2 @ A_TRUE.T
    n_out = int(n * (1 - inlier_frac))
    m1[:n_out, :2] = rng.rand(n_out, 2) * 2 - 1
    m1[:, :2] += rng.randn(n, 2).astype(np.float32) * noise
    valid = rng.rand(n) < valid_frac
    return m1.astype(np.float32), m2, valid


def _jax_counts(m1, m2, valid, samples):
    """JAX's per-hypothesis counts of the affine sets (its solve and count,
    duplicates rejected) and its models."""
    X, Y = jnp.asarray(m1)[samples], jnp.asarray(m2)[samples]
    H, ok = jransac._solve_models(X, Y, "affine", "abs", "projective")
    counts = jransac._make_count_chunk(jnp.asarray(m1), jnp.asarray(m2), jnp.asarray(valid),
                                       TOL)(H)
    unique = np.array([len(set(r)) == 3 for r in samples])
    return np.asarray(counts) * (unique & np.asarray(ok)), np.asarray(H)


# ---------------------------------------------------------------------------
# fit_affine and affine_grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [3, 5])
def test_fit_affine_matches_jax(rng, n):
    """Batched least-squares fits of n points against JAX's, on the sets
    whose normal matrix has a condition number below 100: each matrix to
    1e-5 of its largest entry; the last row exactly [0, 0, 1]."""
    X = np.concatenate([rng.rand(512, n, 2) * 2 - 1, np.ones((512, n, 1))], -1)
    Y = np.concatenate([rng.rand(512, n, 2) * 2 - 1, np.ones((512, n, 1))], -1)
    X, Y = X.astype(np.float32), Y.astype(np.float32)
    well = np.linalg.cond(np.einsum("bni,bnj->bij", Y.astype(np.float64), Y)) < 100
    assert well.sum() > 200
    ours = fit_affine(t(X[well]), t(Y[well])).numpy()
    ref = np.asarray(j_fit_affine(jnp.asarray(X[well]), jnp.asarray(Y[well])))
    scale = np.abs(ref).max(axis=(1, 2), keepdims=True)
    np.testing.assert_array_less(np.abs(ours - ref) / scale, 1e-5)
    np.testing.assert_array_equal(ours[:, 2], np.tile([0.0, 0.0, 1.0], (well.sum(), 1)))


def test_fit_affine_recovers_an_exact_map(rng):
    m2 = np.concatenate([rng.rand(6, 2) * 2 - 1, np.ones((6, 1))], 1).astype(np.float32)
    m1 = m2 @ A_TRUE.T
    np.testing.assert_allclose(fit_affine(t(m1), t(m2)).numpy(), A_TRUE, atol=1e-5)


def test_affine_grid_matches_jax_and_torch(rng):
    """`affine_grid` against JAX's and `F.affine_grid(align_corners=True)`,
    to 1e-6 (fp32 linspace and a 3-term product)."""
    theta = (rng.rand(3, 2, 3) * 2 - 1).astype(np.float32)
    for h, w in ((5, 7), (48, 64)):
        ours = affine_grid(t(theta), h, w).numpy()
        np.testing.assert_allclose(ours, np.asarray(j_affine_grid(jnp.asarray(theta), h, w)),
                                   atol=1e-6)
        torch_grid = F.affine_grid(t(theta), (3, 1, h, w), align_corners=True).numpy()
        np.testing.assert_allclose(ours, torch_grid, atol=1e-6)


# ---------------------------------------------------------------------------
# affine RANSAC against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("valid_frac", [1.0, 0.8])
def test_fixed_affine_ransac_matches_jax(rng, valid_frac):
    """The plain fit against JAX's `ransac_homography(transform='affine',
    n_points=3)` under the same injected sets (the port's Philox draws):
    winner set, count, found and mask equal, H to 1e-5. Every count of a
    set whose normal matrix YtY has a condition number below 1e3 is equal or
    a flip at the tolerance boundary (`boundary_flips`); on worse
    conditioned sets JAX's fp32 LU solve and the port's closed form part by
    up to cond * 6e-8 relative (the watch list in ROADMAP.md), and at most
    1% of all counts differ (3 of 800 here, each with cond > 1.5e3)."""
    m1, m2, valid = _affine_problem(rng, valid_frac=valid_frac)
    samples = draw_sets_ref(t(valid), _seed(31), 800, n_points=3)
    ref = jransac.ransac_homography(
        jax.random.PRNGKey(0), jnp.asarray(m1), jnp.asarray(m2), jnp.asarray(valid), TOL,
        n_iter=800, n_points=3, transform="affine",
        injected_samples=jnp.asarray(samples.numpy()))
    ours = ransac.ransac_homography(t(m1), t(m2), t(valid), TOL, n_iter=800,
                                    injected_samples=samples, n_points=3, transform="affine")
    assert bool(ours.found) == bool(ref.found)
    assert int(ours.num_inliers) == int(ref.num_inliers) > 150
    np.testing.assert_array_equal(ours.best_sample.numpy(), np.asarray(ref.best_sample))
    np.testing.assert_allclose(ours.H21.numpy(), np.asarray(ref.H21), atol=ATOL_H21)
    np.testing.assert_array_equal(ours.inlier_mask.numpy(), np.asarray(ref.inlier_mask))
    _, counts = ransac_score_ref(t(m1), t(m2), t(valid), samples, TOL, "affine")
    counts_ref, _ = _jax_counts(m1, m2, valid, samples.numpy())
    differ, explained = boundary_flips(t(m1), t(m2), t(valid), samples, counts,
                                       t(counts_ref.astype(np.int32)), TOL,
                                       transform="affine")
    Y = m2[samples.numpy()].astype(np.float64)
    well = t(np.linalg.cond(np.einsum("bni,bnj->bij", Y, Y)) < 1e3)
    assert bool((~differ | explained)[well].all())
    assert differ.float().mean().item() <= 0.01


def test_collinear_set_pinned_to_jax(rng):
    """An exactly collinear injected set: JAX's LU solve gives a model whose
    linear part has no finite entry (nan and +-inf), the port's closed form
    nan entries (the watch list in ROADMAP.md); both score it 0, and a fit
    of it alone finds nothing."""
    m1, m2, valid = _affine_problem(rng, n=40)
    m2[:3, :2] = [[0.0, 0.0], [0.5, 0.5], [1.0, 1.0]]
    samples = np.array([[0, 1, 2], [5, 9, 14]], np.int32)
    counts_ref, H_ref = _jax_counts(m1, m2, valid, samples)
    assert counts_ref[0] == 0 and not np.isfinite(H_ref[0, :2, :2]).any()
    H, counts = ransac_score_ref(t(m1), t(m2), t(valid), t(samples), TOL, "affine")
    assert int(counts[0]) == 0 and torch.isnan(H[0, :2]).all()
    assert int(counts[1]) == int(counts_ref[1])
    ref = jransac.ransac_homography(
        jax.random.PRNGKey(0), jnp.asarray(m1), jnp.asarray(m2), jnp.asarray(valid), TOL,
        n_iter=1, n_points=3, transform="affine", injected_samples=jnp.asarray(samples[:1]))
    ours = ransac.ransac_homography(t(m1), t(m2), t(valid), TOL, n_iter=1,
                                    injected_samples=t(samples[:1]), n_points=3,
                                    transform="affine")
    assert not bool(ours.found) and not bool(ref.found)
    assert int(ours.num_inliers) == int(ref.num_inliers) == 0
    assert not ours.inlier_mask.any() and not np.asarray(ref.inlier_mask).any()


def _reference_block_draws(key, valid, n_iter, chunk, n_points=3):
    """JAX's per-block minimal sets of `ransac_homography_adaptive` under
    `key` as match indices: block i draws under fold_in(key, i)."""
    n_valid = jnp.sum(jnp.asarray(valid).astype(jnp.int32))
    order = np.argsort(~valid, kind="stable")
    blocks = []
    for i in range(-(-n_iter // chunk)):
        raw, _ = jransac._sample_minimal_sets(jax.random.fold_in(key, i), n_valid,
                                              n_points, chunk)
        blocks.append(order[np.asarray(raw)])
    return np.concatenate(blocks).astype(np.int32)


@pytest.mark.parametrize("case", ["clean", "structureless", "degenerate"])
def test_adaptive_affine_matches_jax_under_its_draws(rng, case):
    """The adaptive loop (stop test on w ** 3) under JAX's per-block draws:
    blocks run, stop, count, set, found and mask equal, H to 1e-5."""
    if case == "clean":  # 70% inliers: one block
        m1, m2, valid = _affine_problem(rng)
        tol, n_iter, chunk = TOL, 50000, 1024
    elif case == "structureless":  # to the cap
        m1, m2, valid = _affine_problem(rng, inlier_frac=0.0)
        tol, n_iter, chunk = 0.003, 4096, 1024
    else:  # 2 valid matches: never found
        m1, m2, valid = _affine_problem(rng, n=10)
        valid[:] = False
        valid[[3, 7]] = True
        tol, n_iter, chunk = TOL, 1024, 512
    key = jax.random.PRNGKey(0)
    ref, ref_eval = jransac.ransac_homography_adaptive(
        key, jnp.asarray(m1), jnp.asarray(m2), jnp.asarray(valid), tolerance=tol,
        n_iter=n_iter, chunk=chunk, n_points=3, transform="affine")
    samples = _reference_block_draws(key, valid, n_iter, chunk)
    ours, ours_eval = ransac.ransac_homography_adaptive(
        t(m1), t(m2), t(valid), tol, n_iter=n_iter, chunk=chunk, injected_samples=t(samples),
        n_points=3, transform="affine")
    expected = {"clean": (chunk, True), "structureless": (4096, True),
                "degenerate": (n_iter, False)}[case]
    assert (int(ours_eval), bool(ours.found)) == (int(ref_eval), bool(ref.found)) == expected
    assert int(ours.num_inliers) == int(ref.num_inliers)
    np.testing.assert_array_equal(ours.best_sample.numpy(), np.asarray(ref.best_sample))
    np.testing.assert_allclose(ours.H21.numpy(), np.asarray(ref.H21), atol=ATOL_H21)
    np.testing.assert_array_equal(ours.inlier_mask.numpy(), np.asarray(ref.inlier_mask))


def test_three_point_draws_are_the_first_three_columns(rng):
    """Under one seed an affine set is the first three indices of the
    homography set, through the plain draws and through the ops."""
    valid = t(rng.rand(500) > 0.3)
    seed = _seed(0x1234_5678_9ABC)
    four = draw_sets_ref(valid, seed, 3000, first=7)
    three = draw_sets_ref(valid, seed, 3000, first=7, n_points=3)
    assert three.shape == (3000, 3) and torch.equal(three, four[:, :3])
    a = ransac.sample_minimal_sets(valid, 256, torch.Generator().manual_seed(5), n_points=3)
    b = ransac.sample_minimal_sets(valid, 256, torch.Generator().manual_seed(5))
    assert torch.equal(a, b[:, :3])


def test_affine_sampler_distribution(rng):
    """test_torch_multihomo's distributional parity for the 3-point
    sampler: the adaptive loop stops early and finds what the fixed-count
    fit finds (means of the counts within 3, the model gaps of the same
    size), and the draws are uniform over the valid matches."""
    m1, m2, valid = _affine_problem(rng, n=240, inlier_frac=0.55)
    n_out = int(240 * 0.45)
    tgt = m2[n_out:].astype(np.float64)

    def gap(ha, hb):
        return np.abs(tgt @ ha.numpy().T.astype(np.float64)
                      - tgt @ hb.numpy().T.astype(np.float64))[:, :2].max()

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    kw = dict(n_points=3, transform="affine")
    counts_fx, counts_ad, gaps_ff, gaps_fa = [], [], [], []
    for seed in range(8):
        fx = ransac.ransac_homography(t(m1), t(m2), t(valid), TOL, n_iter=2048,
                                      generator=gen(seed), **kw)
        fx2 = ransac.ransac_homography(t(m1), t(m2), t(valid), TOL, n_iter=2048,
                                       generator=gen(200 + seed), **kw)
        ad, n_eval = ransac.ransac_homography_adaptive(
            t(m1), t(m2), t(valid), TOL, n_iter=2048, chunk=256, generator=gen(100 + seed),
            **kw)
        assert int(n_eval) < 2048
        counts_fx.append(int(fx.num_inliers))
        counts_ad.append(int(ad.num_inliers))
        gaps_ff.append(gap(fx.H21, fx2.H21))
        gaps_fa.append(gap(fx.H21, ad.H21))
    assert abs(np.mean(counts_fx) - np.mean(counts_ad)) <= 3.0
    assert np.median(gaps_fa) <= max(2.0 * np.median(gaps_ff), 0.01)
    assert np.max(gaps_fa) <= max(2.0 * np.max(gaps_ff), 0.01)
    sets = draw_sets_ref(t(valid), _seed(9), 20000, n_points=3)
    hist = torch.bincount(sets.flatten().long(), minlength=240).float()
    assert hist.min() > 0.7 * hist.mean() and hist.max() < 1.3 * hist.mean()


def test_transform_and_set_size_must_agree(rng):
    m1, m2, valid = (t(a) for a in _affine_problem(rng, n=20))
    for kw in (dict(n_points=4, transform="affine"), dict(n_points=3),
               dict(n_points=3, transform="similarity")):
        with pytest.raises(ValueError):
            ransac.ransac_homography(m1, m2, valid, TOL, n_iter=8,
                                     generator=torch.Generator(), **kw)
    with pytest.raises(ValueError):
        ransac.ransac_homography(m1, m2, valid, TOL, n_iter=8, n_points=3, transform="affine",
                                 injected_samples=torch.zeros((8, 4), dtype=torch.int32))


# ---------------------------------------------------------------------------
# CoarseAligner(transform='affine') and the loops against JAX
# ---------------------------------------------------------------------------


def test_get_coarse_affine_matches_jax(rng, nets):
    """`get_coarse` of both packages under one set of injected 3-cell sets:
    the affine H to 1e-5 (no fp64 polish for affine maps in either), the
    inlier cells equal; the translation recovered."""
    pair = _translated_pair(rng)
    j, ours = _aligners(nets, pair, transform="affine")
    assert ours.n_points == 3 and ours.transform == "affine"
    mask = _border_mask()
    _, _, valid = ours._masked_matches(mask)
    samples = rng.choice(np.flatnonzero(valid.numpy()), (512, 3)).astype(np.int32)
    h_ref, inl_ref = j.get_coarse(mask, injected_samples=samples)
    h, inl = ours.get_coarse(mask, injected_samples=samples)
    assert h.dtype == np.float32 and np.array_equal(h[2], [0.0, 0.0, 1.0])
    np.testing.assert_allclose(h, h_ref, atol=ATOL_H21)
    np.testing.assert_array_equal(inl, inl_ref)
    assert _h_error(h, pair[2]) < 0.02
    ours.reseed(0)
    h_drawn, _ = ours.get_coarse(mask)
    assert _h_error(h_drawn, pair[2]) < 0.02
    # fewer valid cells than a set: no model, as in JAX
    assert ours.get_coarse(np.ones_like(mask)) == (None, None)


def test_multi_homography_predict_affine_matches_jax(rng, nets, monkeypatch):
    """The host loop with affine fits under JAX's draws, recorded for its key
    and replayed: the stacks to 1e-4 (fp32 conv stacks in two libraries)."""
    _, ja, _, align = nets
    pair = _translated_pair(rng)
    j, ours = _aligners(nets, pair, transform="affine")
    recorded = []
    j_ransac = jcoarse.ransac_homography

    def recording(key, m1, m2, valid, tolerance, n_iter=10000, **kw):
        raw, _ = jransac._sample_minimal_sets(key, jnp.sum(valid.astype(jnp.int32)),
                                              kw["n_points"], n_iter)
        recorded.append(np.asarray(jnp.argsort(~valid, stable=True)[raw], np.int32))
        return j_ransac(key, m1, m2, valid, tolerance, n_iter=n_iter, **kw)

    t_ransac = coarse.ransac_homography

    def replaying(m1, m2, valid, tolerance, n_iter=10000, generator=None, **kw):
        return t_ransac(m1, m2, valid, tolerance, n_iter=n_iter,
                        injected_samples=t(recorded.pop(0)), n_points=kw["n_points"],
                        transform=kw["transform"])

    monkeypatch.setattr(jcoarse, "ransac_homography", recording)
    monkeypatch.setattr(coarse, "ransac_homography", replaying)
    kw = dict(max_coarse=2, mask_region_th=0.01, bg_mask=1.0 - _border_mask())
    ref = jmultihomo.multi_homography_predict(j, ja, **kw)
    n_fits = len(recorded)
    out = multihomo.multi_homography_predict(ours, align, **kw)
    assert n_fits > 0 and not recorded
    assert out["coarse_h"].shape[0] == ref["coarse_h"].shape[0] >= 1
    for key in ("coarse_h", "fine_flow_down8", "fine_match_down8"):
        np.testing.assert_allclose(out[key], ref[key], atol=1e-4)
    assert _h_error(out["coarse_h"][0], pair[2]) < 0.02


def test_fused_loop_affine_matches_jax_and_host_loop(rng, nets):
    """The device-resident loop with affine fits against JAX's loop (other
    draws: the count and the first map within 0.01) and against the port's
    host loop on the same aligner."""
    _, ja, _, align = nets
    pair = _translated_pair(rng)
    j, ours = _aligners(nets, pair, polish_fp64=False, transform="affine")
    bg = 1.0 - _border_mask()
    jargs, targs, kw = _loop_inputs(j, ours, ja, align, bg)
    ref = jmultihomo._fused_multi_homo(*jargs, jax.random.PRNGKey(3), 0.05, 0.01,
                                       n_points=3, transform="affine", rematch=False, **kw)
    out = multihomo._fused_multi_homo(*targs, torch.Generator().manual_seed(3), 0.05, 0.01,
                                      rematch=False, n_points=3, transform="affine", **kw)
    assert int(out["count"]) == int(ref["count"]) >= 1
    assert _h_error(out["hs"][0].numpy(), np.asarray(ref["hs"][0])) < 0.01
    assert np.array_equal(out["hs"][0, 2].numpy(), [0.0, 0.0, 1.0])
    loop_kw = dict(max_coarse=2, mask_region_th=0.01, bg_mask=bg)
    host = multihomo.multi_homography_predict(ours, align, **loop_kw)
    fused = multihomo.multi_homography_predict_fused(ours, align, **loop_kw)
    assert _h_error(fused["coarse_h"][0], host["coarse_h"][0]) < 0.01
    assert _h_error(fused["coarse_h"][0], pair[2]) < 0.02


# ---------------------------------------------------------------------------
# on the card: kernels 3 and 4, affine and past the shared-memory order
# ---------------------------------------------------------------------------


def _assert_fit_matches(fit, rec, ref, rec_ref, m1, m2, valid, transform):
    n_rows = rec_ref.counts.shape[0]
    assert torch.equal(rec.sets[:n_rows], rec_ref.sets)
    differ, explained = boundary_flips(m1, m2, valid, rec_ref.sets, rec.counts[:n_rows],
                                       rec_ref.counts, TOL, transform=transform)
    assert 1 - (differ & ~explained).float().mean().item() >= 0.999
    assert int(fit.num_inliers) == int(ref.num_inliers)
    assert bool(fit.found) == bool(ref.found)
    assert torch.equal(fit.best_sample, ref.best_sample)
    torch.testing.assert_close(fit.H21, ref.H21, atol=1e-5, rtol=0)
    off = (reprojection_error(m1, m2, ref.H21[None])[0] - TOL).abs() > 1e-6
    assert torch.equal(fit.inlier_mask[off], ref.inlier_mask[off])


@pytest.mark.gpu
@pytest.mark.parametrize("transform,n,n_iter", [("affine", 1200, 10000), ("affine", 5000, 777),
                                                ("affine", 60000, 1000),
                                                ("homography", 60000, 1000)])
def test_fit_kernel_matches_plain_affine_and_large(cuda, rng, transform, n, n_iter):
    """Kernel 3 against its plain version on one seed: the affine form, and
    both forms past `SHARED_ORDER_MAX` matches (the global order)."""
    m1, m2, valid = (t(a).to(cuda) for a in _affine_problem(rng, n=n, valid_frac=0.85))
    seed = _seed(4242 + n).to(cuda)
    kernels.reset_launch_counts()
    fit, rec = ransac_fit(m1, m2, valid, TOL, n_iter, seed=seed, record=True,
                          transform=transform)
    assert kernels.launch_counts()["ransac_score"] == 1
    ref, rec_ref = ransac_fit_ref(m1, m2, valid, TOL, n_iter, seed=seed, transform=transform)
    _assert_fit_matches(fit, rec, ref, rec_ref, m1, m2, valid, transform)


@pytest.mark.gpu
@pytest.mark.parametrize("transform,n,frac,blocks", [("affine", 1200, 0.6, 1),
                                                     ("affine", 1200, 0.0, 13),
                                                     ("homography", 60000, 0.6, 1)])
def test_adaptive_kernel_matches_plain_affine_and_large(cuda, rng, transform, n, frac, blocks):
    m1, m2, valid = (t(a).to(cuda) for a in _affine_problem(rng, n=n, inlier_frac=frac))
    seed = _seed(78).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fit, n_eval, rec = ransac_adaptive(m1, m2, valid, TOL, 50000, 4096, 0.999, seed=seed,
                                           record=True, transform=transform)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref, n_eval_ref, rec_ref = ransac_adaptive_ref(m1, m2, valid, TOL, 50000, 4096, 0.999,
                                                   seed=seed, transform=transform)
    assert int(n_eval) == int(n_eval_ref) == blocks * 4096
    _assert_fit_matches(fit, rec, ref, rec_ref, m1, m2, valid, transform)


@pytest.mark.gpu
def test_kernels_raise_above_the_match_limit(cuda):
    """Above MAX_MATCHES (3 N past int32) both kernels raise ValueError
    (stride-0 views: nothing that large is allocated)."""
    n = MAX_MATCHES + 1
    m = torch.ones((1, 3), device=cuda).expand(n, 3)
    valid = torch.ones(1, dtype=torch.bool, device=cuda).expand(n)
    with pytest.raises(ValueError, match="at most"):
        ransac_fit(m, m, valid, TOL, 8, seed=_seed(1).to(cuda))
    with pytest.raises(ValueError, match="at most"):
        ransac_adaptive(m, m, valid, TOL, 8, 8, 0.99, seed=_seed(1).to(cuda))
