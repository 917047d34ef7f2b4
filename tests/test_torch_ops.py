"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

The same numpy-seeded inputs go through the JAX function and its port. The
kernel wrappers take their plain versions for CPU tensors, so these tests
hold the plain versions against JAX; the `gpu` tests hold the CUDA kernels
against the plain versions and skip without a card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ransacflow_tpu.ops import (
    blurpool as jblur,
    correlation as jcorr,
    grid as jgrid,
    homography as jhom,
    matching as jmatch,
    ransac as jransac,
    sampler as jsampler,
)
from ransacflow_tpu.ops.correlation import corr_offset_grids as j_corr_offset_grids
from ransacflow_tpu.pipeline import fused as jfused
from ransacflow_tpu_torch import kernels
from ransacflow_tpu_torch.kernels import pyramid
from ransacflow_tpu_torch.kernels.adaptive_pool import ppm_pool
from ransacflow_tpu_torch.kernels.anchor_resample import anchor_resample_feats
from ransacflow_tpu_torch.kernels.blurpool import binomial_filter, blur_pool, blur_pool_ref
from ransacflow_tpu_torch.kernels.compose import compose_tail, compose_tail_ref
from ransacflow_tpu_torch.kernels.correlation import correlation_volume, correlation_volume_ref
from ransacflow_tpu_torch.kernels.heads import (
    flow_epilogue,
    flow_epilogue_ref,
    match_epilogue,
    match_epilogue_ref,
)
from ransacflow_tpu_torch.kernels.matching import mutual_argmax, mutual_argmax_ref
from ransacflow_tpu_torch.kernels.ransac import ransac_score, ransac_score_ref
from ransacflow_tpu_torch.kernels.ransac_adaptive import ransac_adaptive, ransac_adaptive_ref
from ransacflow_tpu_torch.kernels.ssim import masked_ssim_loss, masked_ssim_loss_ref
from ransacflow_tpu_torch.kernels.warp_sample import warp_sample, warp_sample_ref
from ransacflow_tpu_torch.ops import (
    blurpool,
    grid,
    homography,
    matching,
    ransac,
    sampler,
)

ATOL = 1e-5  # fp32 elementwise ops, same formulas, other libraries


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(ours, ref, atol=ATOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=atol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_grids(rng):
    close(grid.normalized_grid(5, 7, "cpu"), jgrid.normalized_grid(5, 7))
    for ours, ref in zip(grid.feature_cell_coords(4, 6, "cpu"),
                         jgrid.feature_cell_coords(4, 6)):
        close(ours, ref)


def _point_sets(rng, n):
    return rng.uniform(-1, 1, (n, 4, 3)).astype(np.float32), \
        rng.uniform(-1, 1, (n, 4, 3)).astype(np.float32)


def test_dlt_homography_projective(rng):
    X, Y = _point_sets(rng, 64)
    close(homography.dlt_homography(t(X), t(Y)),
          jhom.dlt_homography(jnp.asarray(X), jnp.asarray(Y)))
    # the helpers it is built from, one by one
    P = X[..., :2]
    for ours, ref in zip(homography._hartley_normalize(t(P)),
                         jhom._hartley_normalize(jnp.asarray(P))):
        close(ours, ref)
    M = rng.randn(8, 3, 3).astype(np.float32)
    close(homography._adjugate_3x3(t(M)), jhom._adjugate_3x3(jnp.asarray(M)))
    close(homography._basis_transform(t(P)), jhom._basis_transform(jnp.asarray(P)))


def test_warp_grid_and_reprojection_error(rng):
    H = (np.eye(3) + 0.05 * rng.randn(2, 3, 3)).astype(np.float32)
    close(homography.warp_grid(t(H), 6, 9), jhom.warp_grid(jnp.asarray(H), 6, 9))
    m1 = np.concatenate([rng.uniform(-1, 1, (20, 2)), np.ones((20, 1))], 1).astype(np.float32)
    m2 = np.concatenate([rng.uniform(-1, 1, (20, 2)), np.ones((20, 1))], 1).astype(np.float32)
    close(homography.reprojection_error(t(m1), t(m2), t(H)),
          jhom.reprojection_error(jnp.asarray(m1), jnp.asarray(m2), jnp.asarray(H)))


@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_and_interpolate(rng, align_corners):
    img = rng.rand(2, 7, 9, 3).astype(np.float32)
    g = rng.uniform(-1.2, 1.2, (2, 5, 6, 2)).astype(np.float32)
    close(sampler.grid_sample(t(img), t(g), align_corners),
          jsampler.grid_sample(jnp.asarray(img), jnp.asarray(g), align_corners))
    for oh, ow in ((13, 17), (4, 5)):
        close(sampler.interpolate_bilinear(t(img), oh, ow, align_corners),
              jsampler.interpolate_bilinear(jnp.asarray(img), oh, ow, align_corners))


def test_upsample_x8_and_blur_pool(rng):
    x = rng.rand(1, 4, 5, 2).astype(np.float32)
    close(sampler.upsample_bilinear_x8(t(x)), jsampler.upsample_bilinear_x8(jnp.asarray(x)))
    x = rng.rand(2, 9, 12, 4).astype(np.float32)
    ours = blurpool.BlurPool(4)(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(ours, jblur.blur_pool(jnp.asarray(x)))


@pytest.mark.parametrize("k", [7, 3])
def test_correlation_volume_ref(rng, k):
    x = rng.randn(2, 6, 9, 16).astype(np.float32)
    y = rng.randn(2, 6, 9, 16).astype(np.float32)
    ref = jcorr.correlation_volume(jnp.asarray(x), jnp.asarray(y), k)
    close(correlation_volume_ref(t(x), t(y), k), ref)
    close(correlation_volume(t(x), t(y), k), ref)  # CPU -> the plain version


def _banks(rng, c=16, n_a=70, n_b=30):
    a = rng.randn(c, n_a).astype(np.float32)
    b = rng.randn(c, n_b).astype(np.float32)
    a /= np.linalg.norm(a, axis=0, keepdims=True)
    b /= np.linalg.norm(b, axis=0, keepdims=True)
    a[:, 40] = a[:, 12]   # bank cells 12 and 40 tie exactly ...
    b[:, 3] = a[:, 12]    # ... as the best source of target 3
    valid_b = rng.rand(n_b) > 0.3
    valid_b[3] = True
    return a, b, valid_b


@pytest.mark.parametrize("masked", [False, True])
def test_mutual_matching_ref(rng, masked):
    a, b, valid_b = _banks(rng)
    vb = valid_b if masked else None
    ref = jmatch.mutual_matching(jnp.asarray(a), jnp.asarray(b),
                                 None if vb is None else jnp.asarray(vb))
    for fn in (matching.mutual_matching_ref, matching.mutual_matching):
        ours = fn(t(a), t(b), None if vb is None else t(vb))
        np.testing.assert_array_equal(ours.src_idx.numpy(), np.asarray(ref.src_idx))
        np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
        close(ours.score, ref.score)
        assert ours.src_idx[3] == 12 and ours.valid[3]  # the tie: lowest index
        assert ours.valid.sum() > 3
        if masked:
            assert not ours.valid[~t(valid_b)].any()


def _matches(rng, n=96, inlier_frac=0.6):
    m2 = np.concatenate([rng.uniform(-1, 1, (n, 2)), np.ones((n, 1))], 1)
    h = np.array([[1.05, 0.02, 0.03], [-0.01, 0.97, -0.02], [0.02, -0.03, 1.0]])
    p = m2 @ h.T
    m1 = p[:, :2] / p[:, 2:] + 0.004 * rng.randn(n, 2)
    out = rng.rand(n) > inlier_frac
    m1[out] = rng.uniform(-1, 1, (out.sum(), 2))
    m1 = np.concatenate([m1, np.ones((n, 1))], 1)
    valid = rng.rand(n) > 0.15
    return m1.astype(np.float32), m2.astype(np.float32), valid


def test_ransac_injected_samples(rng):
    m1, m2, valid = _matches(rng)
    samples = rng.randint(0, len(valid), (512, 4)).astype(np.int32)
    samples[:7, 1] = samples[:7, 0]  # duplicate-index sets score 0
    ref = jransac.ransac_homography(
        jax.random.PRNGKey(0), jnp.asarray(m1), jnp.asarray(m2), jnp.asarray(valid),
        0.05, n_iter=512, injected_samples=jnp.asarray(samples))
    ours = ransac.ransac_homography(t(m1), t(m2), t(valid), 0.05, n_iter=512,
                                    injected_samples=t(samples))
    assert int(ours.num_inliers) == int(ref.num_inliers) > 20
    assert bool(ours.found) == bool(ref.found)
    close(ours.H21, ref.H21, atol=1e-4)
    np.testing.assert_array_equal(ours.inlier_mask.numpy(), np.asarray(ref.inlier_mask))
    np.testing.assert_array_equal(ours.best_sample.numpy(), np.asarray(ref.best_sample))
    _, counts = ransac_score_ref(t(m1), t(m2), t(valid), t(samples), 0.05)
    assert (counts[:7] == 0).all()


def test_sampler_draws_valid_indices_and_rejects_duplicates(rng):
    valid = torch.from_numpy(rng.rand(200) > 0.7)
    gen = torch.Generator().manual_seed(0)
    s = ransac.sample_minimal_sets(valid, 20000, gen)
    assert s.dtype == torch.int32 and s.shape == (20000, 4)
    assert valid[s.long()].all()
    # uniform over the valid matches: every one drawn, none far from the mean
    hist = torch.bincount(s.flatten().long(), minlength=200)[valid]
    assert hist.min() > 0.6 * hist.float().mean() and hist.max() < 1.4 * hist.float().mean()
    # with 5 valid matches many sets repeat an index: those score 0
    few = torch.zeros(200, dtype=torch.bool)
    few[[3, 50, 77, 120, 199]] = True
    s = ransac.sample_minimal_sets(few, 500, gen)
    assert few[s.long()].all()
    dup = torch.tensor([len(set(r)) < 4 for r in s.tolist()])
    assert dup.any() and (~dup).any()
    m1, m2, _ = _matches(rng, n=200, inlier_frac=1.0)
    _, counts = ransac_score_ref(t(m1), t(m2), few, s, 0.05)
    assert (counts[dup] == 0).all() and (counts[~dup] > 0).all()
    # no valid match: nothing is found
    res = ransac.ransac_homography(t(m1), t(m2), torch.zeros(200, dtype=torch.bool),
                                   0.05, n_iter=64, generator=gen)
    assert not bool(res.found)


def _warp_grid_with_border(rng, b, h, w):
    """(b, h, w, 2) sampling grids: the identity (every border pixel exactly
    on +-1) and warps that reach past the image."""
    H = np.stack([np.eye(3)] + [np.eye(3) + 0.15 * rng.randn(3, 3) for _ in range(b - 1)])
    return np.array(jhom.warp_grid(jnp.asarray(H.astype(np.float32)), h, w))


def _compose_inputs(rng, b=1, h8=5, w8=7, identity=True):
    ht, wt = 8 * h8, 8 * w8
    flow8 = (0.04 * rng.randn(b, h8, w8, 2)).astype(np.float32)
    flow8[:, 0, :3] = 0.0  # residual 0: the composed point lands on the border
    m12 = rng.rand(b, h8, w8, 1).astype(np.float32)
    m21 = rng.rand(b, h8, w8, 1).astype(np.float32)
    H = np.eye(3) if identity else np.eye(3) + 0.1 * rng.randn(3, 3)
    coarse = np.array(jhom.warp_grid(jnp.asarray(np.repeat(
        H[None], b, 0).astype(np.float32)), ht, wt))
    return flow8, m12, m21, coarse


def _jax_compose_tail(flow8, m12, m21, coarse, cycle_match):
    """`ransacflow_tpu/pipeline/fine.py:61-92` on JAX arrays."""
    ht, wt = coarse.shape[1:3]
    up = lambda x: jsampler.interpolate_bilinear(jnp.asarray(x), ht, wt)  # noqa: E731
    flow_up = jnp.clip(up(flow8) + jgrid.normalized_grid(ht, wt)[None], -1.0, 1.0)
    flow12 = jsampler.grid_sample(jnp.asarray(coarse), flow_up)
    match = up(m12)
    if cycle_match:
        match = match * jsampler.grid_sample(up(m21), flow_up)
    inb = ((flow12[..., 0:1] >= -1) & (flow12[..., 0:1] <= 1)
           & (flow12[..., 1:2] >= -1) & (flow12[..., 1:2] <= 1))
    return flow12, (match * inb)[..., 0]


def test_warp_sample_ref_matches_jax(rng):
    """Kernel 5's plain version on grids that land on +-1 and outside."""
    img = rng.rand(3, 9, 12, 3).astype(np.float32)
    g = _warp_grid_with_border(rng, 3, 7, 10)
    assert (np.abs(g) == 1.0).any() and (np.abs(g) > 1.0).any()
    close(warp_sample_ref(t(img), t(g)), jsampler.grid_sample(jnp.asarray(img), jnp.asarray(g)))


@pytest.mark.parametrize("cycle_match", [True, False])
def test_compose_tail_ref_matches_jax(rng, cycle_match):
    """Kernel 8's plain version, grids exactly on the border included."""
    for identity in (True, False):
        args = _compose_inputs(rng, b=1, identity=identity)
        flow12, match = compose_tail_ref(*map(t, args), cycle_match)
        ref_flow, ref_match = _jax_compose_tail(*args, cycle_match)
        close(flow12, ref_flow)
        close(match, ref_match)


def test_head_epilogues_ref_match_jax(rng):
    """Kernel 7's plain versions: models/heads.py:69-99 after conv4."""
    logits = (3 * rng.randn(2, 5, 6, 49)).astype(np.float32)
    p = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    gx, gy = j_corr_offset_grids(7)
    ref = jnp.stack([jnp.sum(p * gx, -1) / 6 * 2.0, jnp.sum(p * gy, -1) / 5 * 2.0], -1)
    close(flow_epilogue_ref(t(logits), 7), ref)
    close(match_epilogue_ref(t(logits[..., :1])), jax.nn.sigmoid(jnp.asarray(logits[..., :1])))


def test_cpu_tensors_take_the_plain_versions(rng):
    kernels.reset_launch_counts()
    x = t(rng.randn(1, 4, 5, 8).astype(np.float32))
    torch.testing.assert_close(correlation_volume(x, x, 3), correlation_volume_ref(x, x, 3))
    score = t(rng.randn(20, 9).astype(np.float32))
    for ours, ref in zip(mutual_argmax(score), mutual_argmax_ref(score)):
        torch.testing.assert_close(ours, ref)
    m1, m2, valid = _matches(rng, n=32)
    s = t(rng.randint(0, 32, (16, 4)).astype(np.int32))
    for ours, ref in zip(ransac_score(t(m1), t(m2), t(valid), s, 0.05),
                         ransac_score_ref(t(m1), t(m2), t(valid), s, 0.05)):
        torch.testing.assert_close(ours, ref, equal_nan=True)
    for ours, ref in zip(ransac_adaptive(t(m1), t(m2), t(valid), s, 8, 16, 0.05, 0.999),
                         ransac_adaptive_ref(t(m1), t(m2), t(valid), s, 8, 16, 0.05, 0.999)):
        torch.testing.assert_close(ours, ref)
    img, g = t(rng.rand(1, 6, 7, 3).astype(np.float32)), t(_warp_grid_with_border(rng, 1, 4, 5))
    torch.testing.assert_close(warp_sample(img, g), warp_sample_ref(img, g))
    args = tuple(map(t, _compose_inputs(rng)))
    for ours, ref in zip(compose_tail(*args, True), compose_tail_ref(*args, True)):
        torch.testing.assert_close(ours, ref)
    logits = t(rng.randn(1, 3, 4, 9).astype(np.float32))
    torch.testing.assert_close(flow_epilogue(logits, 3), flow_epilogue_ref(logits, 3))
    torch.testing.assert_close(match_epilogue(logits), match_epilogue_ref(logits))
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.gpu
def test_correlation_kernel_on_card(cuda, rng):
    x = t(rng.randn(2, 13, 21, 40).astype(np.float32)).to(cuda)
    y = t(rng.randn(2, 13, 21, 40).astype(np.float32)).to(cuda)
    for k in (7, 3, 11):
        torch.testing.assert_close(correlation_volume(x, y, k),
                                   correlation_volume_ref(x, y, k), atol=1e-4, rtol=0)
    with pytest.raises(ValueError):
        correlation_volume(x[..., :-1], y[..., 1:], 7)  # not contiguous


@pytest.mark.gpu
def test_mutual_argmax_kernel_on_card(cuda, rng):
    a, b, valid_b = _banks(rng, c=32, n_a=3000, n_b=300)
    score = ((t(a).T @ t(b)) * t(valid_b).float()[None]).to(cuda)
    score[5, 7] = float("nan")
    for ours, ref in zip(mutual_argmax(score), mutual_argmax_ref(score)):
        torch.testing.assert_close(ours, ref, atol=0, rtol=0, equal_nan=True)


@pytest.mark.gpu
def test_ransac_score_kernel_on_card(cuda, rng):
    m1, m2, valid = _matches(rng, n=1500)
    s = t(rng.randint(0, 1500, (3000, 4)).astype(np.int32))
    s[:5, 2] = s[:5, 3]
    args = [x.to(cuda) for x in (t(m1), t(m2), t(valid), s)]
    H_k, c_k = ransac_score(*args, 0.05)
    H_r, c_r = ransac_score_ref(*args, 0.05)
    assert (c_k[:5] == 0).all()
    assert (c_k == c_r).float().mean() >= 0.999
    ok = c_r > 0
    torch.testing.assert_close(H_k[ok], H_r[ok], atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("structured", [True, False])
def test_ransac_adaptive_kernel_on_card(cuda, rng, structured):
    """Kernel 4 against its plain version on the same draws, the stop test
    under sync-debug 'error' (nothing reads back)."""
    m1, m2, valid = _matches(rng, n=1200, inlier_frac=0.6 if structured else 0.0)
    m1, m2, valid = (x.to(cuda) for x in (t(m1), t(m2), t(valid)))
    gen = torch.Generator(device=cuda).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        samples = ransac.sample_minimal_sets(valid, 12 * 1024, gen)
        H, count, sample, chunks = ransac_adaptive(m1, m2, valid, samples, 1024,
                                                   12000, 0.05, 0.999)
        res, n_eval = ransac.ransac_homography_adaptive(m1, m2, valid, 0.05, n_iter=12000,
                                                        chunk=1024, generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(res.found) and int(n_eval) % 1024 == 0
    H_r, count_r, sample_r, chunks_r = ransac_adaptive_ref(m1, m2, valid, samples, 1024,
                                                           12000, 0.05, 0.999)
    assert int(count) == int(count_r) and int(chunks) == int(chunks_r)
    assert int(chunks) == (1 if structured else 12)
    torch.testing.assert_close(sample, sample_r)
    torch.testing.assert_close(H, H_r, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_warp_sample_kernel_on_card(cuda, rng):
    img = t(rng.rand(2, 37, 53, 3).astype(np.float32)).to(cuda)
    g = t(_warp_grid_with_border(rng, 2, 29, 41)).to(cuda)
    torch.testing.assert_close(warp_sample(img, g), warp_sample_ref(img, g),
                               atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_head_epilogue_kernels_on_card(cuda, rng):
    logits = t((3 * rng.randn(2, 13, 17, 49)).astype(np.float32)).to(cuda)
    torch.testing.assert_close(flow_epilogue(logits, 7), flow_epilogue_ref(logits, 7),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(match_epilogue(logits[..., :1].contiguous()),
                               match_epilogue_ref(logits[..., :1]), atol=1e-6, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("cycle_match", [True, False])
def test_compose_tail_kernel_on_card(cuda, rng, cycle_match):
    for identity in (True, False):
        args = [x.to(cuda) for x in map(t, _compose_inputs(rng, b=2, identity=identity))]
        flow, match = compose_tail(*args, cycle_match)
        flow_r, match_r = compose_tail_ref(*args, cycle_match)
        torch.testing.assert_close(flow, flow_r, atol=1e-5, rtol=0)
        # the in-bounds mask is a step at |flow12| = 1: compare off it
        off = ((flow_r.abs() - 1).abs() > 1e-5).all(dim=-1)
        torch.testing.assert_close(match[off], match_r[off], atol=1e-5, rtol=0)
        assert off.float().mean() > 0.8


def _forward_only_calls(rng, device):
    """(name, call) of every forward-only wrapper on inputs that require grad."""
    m1, m2, valid = _matches(rng, n=32)
    m1, m2, valid = (t(a).to(device) for a in (m1, m2, valid))
    s = t(rng.randint(0, 32, (16, 4)).astype(np.int32)).to(device)
    f8, m12, m21, coarse = (t(a).to(device) for a in _compose_inputs(rng))
    score = t(rng.randn(20, 9).astype(np.float32)).to(device)
    img = t(rng.rand(1, 16, 20, 3).astype(np.float32)).to(device)
    g = lambda x: x.clone().requires_grad_()  # noqa: E731
    return [("mutual_argmax", lambda: mutual_argmax(g(score))),
            ("ransac_score", lambda: ransac_score(g(m1), m2, valid, s, 0.05)),
            ("ransac_adaptive", lambda: ransac_adaptive(m1, g(m2), valid, s, 8, 16, 0.05,
                                                        0.999)),
            ("compose_tail", lambda: compose_tail(g(f8), m12, m21, coarse, True)),
            ("device_pyramid", lambda: pyramid.device_pyramid(g(img), [(8, 10)])),
            ("mutual_argmax relaxed", lambda: mutual_argmax(g(score), 1, 3)),
            ("anchor_resample_feats", lambda: anchor_resample_feats(g(img), 5, 7)),
            ("ppm_pool", lambda: ppm_pool(g(img)))]


def test_forward_only_wrappers_raise_under_grad(rng):
    """K1, K2 (exact and relaxed), K3, K4, K8, K12 and K13 have no backward:
    under grad mode an input that requires grad raises instead of handing
    back a tensor cut off from the graph; under no_grad they run."""
    for name, call in _forward_only_calls(rng, "cpu"):
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()


def test_pyramid_taps_rebuild_the_weight_matrices():
    """Kernel 1's per-output taps (start, count, weights) rebuild the plain
    version's Lanczos-3 matrices exactly, downscale, upscale and identity."""
    for n_in, n_out in ((960, 800), (960, 240), (1280, 320), (64, 32), (32, 64), (50, 50)):
        start, count, w = pyramid.taps(n_in, n_out)
        dense = np.zeros((n_out, n_in), np.float32)
        for o in range(n_out):
            dense[o, start[o]:start[o] + count[o]] = w[o, :count[o]]
        ref = (np.eye(n_in, dtype=np.float32) if n_in == n_out else
               pyramid._lanczos3_weights(n_in, n_out, "cpu").numpy().T)
        np.testing.assert_array_equal(dense, ref)
    assert pyramid.taps(960, 240)[2].shape[1] == 24  # 4x down: 24 taps


def test_device_pyramid_ref_matches_jax(rng):
    """Kernel 1's plain version, one axis at a time included."""
    img = rng.rand(1, 40, 56, 3).astype(np.float32)
    shapes = [(40, 56), (32, 48), (20, 28), (56, 72), (40, 28), (25, 56)]
    for ours, ref in zip(pyramid.device_pyramid(t(img), shapes),
                         jfused.device_pyramid(jnp.asarray(img), shapes)):
        assert ours.shape == ref.shape
        close(ours, ref)


@pytest.mark.gpu
def test_forward_only_wrappers_raise_under_grad_on_card(cuda, rng):
    for name, call in _forward_only_calls(rng, cuda):
        with pytest.raises(RuntimeError, match="no backward"):
            call()


@pytest.mark.gpu
def test_pyramid_kernel_on_card(cuda, rng):
    img = t(rng.rand(2, 96, 128, 3).astype(np.float32)).to(cuda)
    shapes = [(96, 128), (80, 106), (48, 64), (24, 32), (120, 160), (96, 64)]
    kernels.reset_launch_counts()
    got = pyramid.device_pyramid(img, shapes)
    assert kernels.launch_counts()["lanczos_pyramid"] == 1  # every scale, one launch
    assert got[0] is img
    for g, r in zip(got, pyramid.device_pyramid_ref(img, shapes)):
        assert g.shape == r.shape and g.is_contiguous()
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(223, 223), (24, 31), (112, 112)])
@pytest.mark.parametrize("channels_last", [False, True])
def test_blur_pool_kernels_on_card(cuda, rng, hw, channels_last):
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = t(rng.randn(2, 5, *hw).astype(np.float32)).to(cuda).contiguous(memory_format=fmt)
    filt = binomial_filter(5, 3, cuda)
    xk, xr = x.clone().requires_grad_(), x.clone().requires_grad_()
    yk, yr = blur_pool(xk, filt), blur_pool_ref(xr, filt)
    assert yk.grad_fn is not None and yk.is_contiguous(memory_format=fmt)
    torch.testing.assert_close(yk, yr, atol=1e-6, rtol=0)
    g = torch.randn_like(yr)
    kernels.reset_launch_counts()
    yk.backward(g)
    yr.backward(g)
    assert kernels.launch_counts()["blur_pool_bwd"] == 1
    torch.testing.assert_close(xk.grad, xr.grad, atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        blur_pool(x[:, :, :, 1:], filt)  # a view in neither layout


@pytest.mark.gpu
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_grid_sample_kernels_on_card(cuda, rng, channels):
    """K5 forward and K11 backward against F.grid_sample's autograd, grids
    on +-1 and outside included; the splat only when the image needs it.
    K11 adds with fp32 atomics, in an order that changes from run to run:
    sums of a few terms, so 1e-5."""
    img = t(rng.rand(2, 17, 23, channels).astype(np.float32)).to(cuda)
    grid = t(_warp_grid_with_border(rng, 2, 19, 21)).to(cuda)
    g = torch.randn((2, 19, 21, channels), device=cuda)
    for image_grad in (True, False):
        ik, ir = img.clone().requires_grad_(image_grad), img.clone().requires_grad_(image_grad)
        gk, gr = grid.clone().requires_grad_(), grid.clone().requires_grad_()
        kernels.reset_launch_counts()
        out = warp_sample(ik, gk)
        out.backward(g)
        assert kernels.launch_counts()["grid_sample_bwd"] == 1
        warp_sample_ref(ir, gr).backward(g)
        torch.testing.assert_close(gk.grad, gr.grad, atol=1e-5, rtol=0)
        if image_grad:
            torch.testing.assert_close(ik.grad, ir.grad, atol=1e-5, rtol=0)
        else:
            assert ik.grad is None


@pytest.mark.gpu
def test_correlation_backward_kernel_on_card(cuda, rng):
    x = t(rng.randn(2, 13, 21, 40).astype(np.float32)).to(cuda)
    y = t(rng.randn(2, 13, 21, 40).astype(np.float32)).to(cuda)
    for k in (7, 3):
        g = torch.randn((2, 13, 21, k * k), device=cuda)
        xk, yk, xr, yr = (a.clone().requires_grad_() for a in (x, y, x, y))
        kernels.reset_launch_counts()
        correlation_volume(xk, yk, k).backward(g)
        assert kernels.launch_counts()["correlation_volume_bwd"] == 1
        correlation_volume_ref(xr, yr, k).backward(g)
        torch.testing.assert_close(xk.grad, xr.grad, atol=1e-4, rtol=0)
        torch.testing.assert_close(yk.grad, yr.grad, atol=1e-4, rtol=0)
    # one side only: the other gets no cotangent
    yk = y.clone().requires_grad_()
    correlation_volume(x, yk, 7).sum().backward()
    assert yk.grad is not None


@pytest.mark.gpu
def test_head_epilogue_backward_kernels_on_card(cuda, rng):
    logits = t((3 * rng.randn(2, 13, 17, 49)).astype(np.float32)).to(cuda)
    for fn, ref, width, args in ((flow_epilogue, flow_epilogue_ref, 49, (7,)),
                                 (match_epilogue, match_epilogue_ref, 1, ())):
        lk = logits[..., :width].contiguous().requires_grad_()
        lr = logits[..., :width].contiguous().requires_grad_()
        out = fn(lk, *args)
        g = torch.randn_like(out)
        kernels.reset_launch_counts()
        out.backward(g)
        assert kernels.launch_counts()["head_epilogues_bwd"] == 1
        ref(lr, *args).backward(g)
        torch.testing.assert_close(lk.grad, lr.grad, atol=1e-6, rtol=1e-5)


@pytest.mark.gpu
def test_masked_ssim_kernels_on_card(cuda, rng):
    """K10 forward (a two-pass reduction: deterministic) and backward in
    img1 against the plain version's autograd."""
    img1, img2 = (t(rng.rand(3, 37, 70, 3).astype(np.float32)).to(cuda) for _ in range(2))
    match = t(rng.rand(3, 37, 70, 1).astype(np.float32)).to(cuda)
    match[0] = 0.0  # an image with no valid pixel
    ik, ir = img1.clone().requires_grad_(), img1.clone().requires_grad_()
    lk, lr = masked_ssim_loss(ik, img2, match), masked_ssim_loss_ref(ir, img2, match)
    torch.testing.assert_close(lk, lr, atol=0, rtol=1e-5)
    assert masked_ssim_loss(img1, img2, match).item() == lk.item()  # deterministic
    kernels.reset_launch_counts()
    (2.5 * lk).backward()
    assert kernels.launch_counts()["masked_ssim_bwd"] == 1
    (2.5 * lr).backward()
    torch.testing.assert_close(ik.grad, ir.grad, atol=1e-5 * float(ir.grad.abs().max()),
                               rtol=0)
    with pytest.raises(RuntimeError, match="img2"):
        masked_ssim_loss(img1, img2.clone().requires_grad_(), match)
