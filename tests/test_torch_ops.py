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
from ransacflow_tpu.models import heads as jheads
from ransacflow_tpu.ops.correlation import corr_offset_grids as j_corr_offset_grids
from ransacflow_tpu.pipeline import fused as jfused
from ransacflow_tpu_torch import kernels
from ransacflow_tpu_torch.kernels import compose as kcompose
from ransacflow_tpu_torch.kernels import pyramid
from ransacflow_tpu_torch.kernels.adaptive_pool import ppm_pool
from ransacflow_tpu_torch.kernels.anchor_resample import (
    anchor_resample_feats,
    anchor_resample_feats_ref,
)
from ransacflow_tpu_torch.kernels.blurpool import binomial_filter, blur_pool, blur_pool_ref
from ransacflow_tpu_torch.kernels.compose import compose_tail, compose_tail_ref
from ransacflow_tpu_torch.kernels.correlation import (
    correlation_pair,
    correlation_pair_ref,
    correlation_volume,
    correlation_volume_ref,
)
from ransacflow_tpu_torch.kernels.heads import (
    flow_epilogue,
    flow_epilogue_ref,
    head_epilogues,
    head_epilogues_ref,
    match_epilogue,
    match_epilogue_ref,
)
from ransacflow_tpu_torch.kernels.matching import mutual_argmax, mutual_argmax_ref
from ransacflow_tpu_torch.kernels.ransac import ransac_fit, ransac_fit_ref, ransac_score_ref
from ransacflow_tpu_torch.kernels.ransac_adaptive import ransac_adaptive, ransac_adaptive_ref
from ransacflow_tpu_torch.kernels import ssim as kssim
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


@pytest.mark.parametrize("k", [3, 7, 11])
def test_correlation_pair_ref_matches_jax(rng, k):
    """K6's pair form: corr(x, y) and corr(y, x), the second derived from
    the first by the offset identity, on a non-square map; the CPU wrapper
    takes the plain version and launches nothing."""
    x = rng.randn(2, 6, 9, 16).astype(np.float32)
    y = rng.randn(2, 6, 9, 16).astype(np.float32)
    xy, yx = correlation_pair_ref(t(x), t(y), k)
    close(xy, jcorr.correlation_volume(jnp.asarray(x), jnp.asarray(y), k))
    close(yx, jcorr.correlation_volume(jnp.asarray(y), jnp.asarray(x), k))
    # the same products summed in the same order
    torch.testing.assert_close(yx, correlation_volume_ref(t(y), t(x), k), atol=1e-6, rtol=0)
    kernels.reset_launch_counts()
    for ours, ref in zip(correlation_pair(t(x), t(y), k), (xy, yx)):
        torch.testing.assert_close(ours, ref, atol=0, rtol=0)
    assert set(kernels.launch_counts().values()) == {0}


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


@pytest.mark.parametrize("relax_cells", [0, 1])
def test_mutual_matching_masks_non_finite_targets_as_jax(rng, relax_cells):
    """validB over target cells whose features are +inf, NaN and a large
    negative value. The mask is a product, as in the reference: 0 * NaN and
    0 * inf are NaN, and a masked negative score is -0.0. The +inf column
    (NaN once masked) is then every row's argmax, so the masked NaN column
    after it matches nothing in either package."""
    a, b, valid_b = _banks(rng)  # 30 targets: a 5 x 6 grid
    j_inf, j_nan, j_neg = 8, 17, 25
    b[:, j_inf], b[:, j_nan], b[:, j_neg] = np.inf, np.nan, -1e30
    valid_b[[j_inf, j_nan, j_neg]] = False
    grid_w = 6 if relax_cells else None
    ref = jmatch.mutual_matching(jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid_b),
                                 relax_cells=relax_cells, grid_w=grid_w)
    for fn in (matching.mutual_matching_ref, matching.mutual_matching):
        ours = fn(t(a), t(b), t(valid_b), relax_cells=relax_cells, grid_w=grid_w)
        np.testing.assert_array_equal(ours.src_idx.numpy(), np.asarray(ref.src_idx))
        np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
        close(ours.score, ref.score)
        np.testing.assert_array_equal(np.signbit(ours.score.numpy()),
                                      np.signbit(np.asarray(ref.score)))
        assert not ours.valid[j_nan]
        assert np.isnan(ours.score[j_inf].item()) and ours.score[j_neg].item() == 0


@pytest.mark.parametrize("n_a,n_b,vec,n_sm", [(13065, 1200, True, 132), (13065, 1197, False, 132),
                                              (3001, 301, False, 132), (5000, 3000, True, 132),
                                              (17, 5, False, 132), (1, 1, False, 8)])
def test_mutual_argmax_schedule_covers_the_score(n_a, n_b, vec, n_sm):
    """K2's blocks cover every row and column once: chunks of rows by slices
    of at most MAX_SLICE columns (whole float4s with 16-byte loads), about
    one wave of BLOCKS_PER_SM blocks an SM."""
    from ransacflow_tpu_torch.kernels import matching as kmatch

    n_chunks, rows, n_slices, slice_w = kmatch.schedule(n_a, n_b, vec, n_sm)
    assert (n_chunks - 1) * rows < n_a <= n_chunks * rows
    assert (n_slices - 1) * slice_w < n_b <= n_slices * slice_w <= n_b + 3 * n_slices
    assert slice_w <= kmatch.MAX_SLICE and (not vec or slice_w % 4 == 0)
    assert n_chunks * n_slices <= max(kmatch.BLOCKS_PER_SM * n_sm, n_slices)


@pytest.mark.parametrize("k", [3, 7, 11])
def test_correlation_cotangents_in_neighbourhood_form(rng, k):
    """The form K6's backward kernel computes: with k - 1 = 2p, offset
    kk-1-d is offset d reversed, so both cotangents are neighbourhood sums
    like the forward,
      dx[b,i,j,c] = sum_d g[b,i,j,d] * y[b, i+di-p, j+dj-p, c],
      dy[b,i,j,c] = sum_d g[b, i+di-p, j+dj-p, kk-1-d] * x[b, i+di-p, j+dj-p, c],
    zeros outside the map; equal to autograd of the plain version (fp64)."""
    b, h, w, c, p, kk = 2, 6, 13, 5, k // 2, k * k
    x, y = (torch.from_numpy(rng.randn(b, h, w, c)).requires_grad_() for _ in range(2))
    g = torch.from_numpy(rng.randn(b, h, w, kk))
    dx_ref, dy_ref = torch.autograd.grad(correlation_volume_ref(x, y, k), (x, y), g)
    pad = lambda a: torch.nn.functional.pad(a.detach(), (0, 0, p, p, p, p))  # noqa: E731
    y_pad, x_pad, g_pad = pad(y), pad(x), pad(g)
    dx, dy = torch.zeros_like(dx_ref), torch.zeros_like(dy_ref)
    for d in range(kk):
        di, dj = divmod(d, k)
        nb = lambda a: a[:, di:di + h, dj:dj + w]  # noqa: E731  the neighbour (di, dj)
        dx += g[..., d:d + 1] * nb(y_pad)
        dy += nb(g_pad)[..., kk - 1 - d:kk - d] * nb(x_pad)
    torch.testing.assert_close(dx, dx_ref, atol=1e-12, rtol=0)
    torch.testing.assert_close(dy, dy_ref, atol=1e-12, rtol=0)


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
    op = ransac.ransac_homography(t(m1), t(m2), t(valid), 0.05, n_iter=512,
                                  injected_samples=t(samples))
    fit, record = ransac_fit_ref(t(m1), t(m2), t(valid), 0.05, 512, samples=t(samples))
    for ours in (op, fit):
        assert int(ours.num_inliers) == int(ref.num_inliers) > 20
        assert bool(ours.found) == bool(ref.found)
        close(ours.H21, ref.H21, atol=1e-4)
        np.testing.assert_array_equal(ours.inlier_mask.numpy(), np.asarray(ref.inlier_mask))
        np.testing.assert_array_equal(ours.best_sample.numpy(), np.asarray(ref.best_sample))
    assert (record.counts[:7] == 0).all() and torch.equal(record.sets, t(samples))


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


def _jax_compose_tail(flow8, m12, m21, coarse, cycle_match, out_hw=None):
    """`ransacflow_tpu/pipeline/fine.py:46,61-92` on JAX arrays."""
    ht, wt = out_hw if out_hw is not None else coarse.shape[1:3]
    up = lambda x: jsampler.interpolate_bilinear(jnp.asarray(x), ht, wt)  # noqa: E731
    flow_up = jnp.clip(up(flow8) + jgrid.normalized_grid(ht, wt)[None], -1.0, 1.0)
    match = up(m12)
    if cycle_match and (ht, wt) == coarse.shape[1:3]:
        sampled = jsampler.grid_sample(
            jnp.concatenate([jnp.asarray(coarse), up(m21)], axis=-1), flow_up)
        flow12, match = sampled[..., :2], match * sampled[..., 2:3]
    else:
        flow12 = jsampler.grid_sample(jnp.asarray(coarse), flow_up)
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


# (cycle_match, out_hw): out_hw None keeps the cases' first ids; the others
# compose above and below the 40 x 56 coarse grid
COMPOSE_CASES = [pytest.param(c, None, id=str(c)) for c in (True, False)] + [
    pytest.param(c, hw, id=f"{c}-{hw[0]}x{hw[1]}")
    for c in (True, False) for hw in ((47, 61), (24, 33))]


@pytest.mark.parametrize("cycle_match,out_hw", COMPOSE_CASES)
def test_compose_tail_ref_matches_jax(rng, cycle_match, out_hw):
    """Kernel 8's plain version, grids exactly on the border included, at
    the coarse grid's size and across resolutions (out_hw)."""
    for identity in (True, False):
        args = _compose_inputs(rng, b=1, identity=identity)
        flow12, match = compose_tail_ref(*map(t, args), cycle_match, out_hw)
        ref_flow, ref_match = _jax_compose_tail(*args, cycle_match, out_hw)
        assert flow12.shape == ref_flow.shape and match.shape == ref_match.shape
        close(flow12, ref_flow)
        close(match, ref_match)


def test_compose_tiling_constants_are_the_kernels():
    """The tiling that the emulation below walks is the one in
    `csrc/compose.cu`."""
    import pathlib
    import re

    src = (pathlib.Path(kcompose.__file__).parents[1] / "csrc" / "compose.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"\b(k[A-Za-z]+) = (\d+)\b", src)}
    assert (consts["kTileH"], consts["kTileW"]) == (kcompose.TILE_H, kcompose.TILE_W)
    assert (consts["kSR"], consts["kSC"]) == (kcompose.PATCH_H, kcompose.PATCH_W)
    assert (consts["kHaloR"], consts["kHaloC"]) == (kcompose.HALO_H, kcompose.HALO_W)


def _fma(a, b, c):
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _dot2(a, x, b, y):
    return _fma(a, x, (np.float32(b) * np.float32(y)).astype(np.float32))


def _upsample_axis(dst, n_in, scale):
    """(i0, i1, l0, l1) of `csrc/compose.cu` `upsample_axis`."""
    dst = np.asarray(dst)
    src = np.maximum(_fma(scale, (dst + 0.5).astype(np.float32), -0.5), np.float32(0))
    i0 = src.astype(np.int64)
    l1 = (src - i0.astype(np.float32)).astype(np.float32)
    return i0, i0 + (i0 < n_in - 1), (np.float32(1) - l1).astype(np.float32), l1


def _linspace_pm1(i, n):
    if n == 1:
        return np.full(np.shape(i), -1, np.float32)
    step = np.float32(2) / np.float32(n - 1)
    return np.where(i < n // 2, _fma(step, i, -1.0), _fma(-step, n - i - 1, 1.0))


def _upsampled(at, ay, ax, swap):
    (y0, y1, wy0, wy1), (x0, x1, wx0, wx1) = ay, ax
    a, b = at(y0, x0), at(y0, x1)
    r0 = _dot2(wx1, b, wx0, a) if swap else _dot2(wx0, a, wx1, b)
    return _dot2(wy0, r0, wy1, _dot2(wx0, at(y1, x0), wx1, at(y1, x1)))


def _corners(gx, gy, h, w):
    ix = ((gx + np.float32(1)) * np.float32(0.5)).astype(np.float32) * np.float32(w - 1)
    iy = ((gy + np.float32(1)) * np.float32(0.5)).astype(np.float32) * np.float32(h - 1)
    ix, iy = ix.astype(np.float32), iy.astype(np.float32)
    fx, fy = np.floor(ix), np.floor(iy)
    x0, y0 = fx.astype(np.int64), fy.astype(np.int64)
    wx = ((fx + np.float32(1)) - ix, ix - fx)
    wy = ((fy + np.float32(1)) - iy, iy - fy)
    for k in range(4):
        y, x = y0 + k // 2, x0 + k % 2
        yield y, x, (wx[k % 2] * wy[k // 2]).astype(np.float32), (y >= 0) & (y < h) & (
            x >= 0) & (x < w)


def _patch(m, r0, r1, c0, c1):
    """at(r, c) of map `m` read from its patch [r0, r1) x [c0, c1): every
    read must land inside."""
    patch = m[r0:r1, c0:c1]

    def at(r, c):
        assert (r >= r0).all() and (r < r1).all() and (c >= c0).all() and (c < c1).all()
        return patch[r - r0, c - c0]
    return at


def _emulate_compose(flow8, m12, m21, coarse, cycle_match, out_hw=None):
    """A numpy transliteration of `csrc/compose.cu`'s tiling: each block
    finds the stride-8 cells under its tile, reads flow8 and match12 only
    from that patch when it fits, and a pixel's four match21 corners from
    the wider patch when all lie inside it, else from the map. Returns
    (flow12, match, pixels whose corners came from the patch, from the
    map)."""
    b_, h8, w8, _ = flow8.shape
    hc, wc = coarse.shape[1:3]
    ht, wt = out_hw if out_hw is not None else (hc, wc)
    sh, sw = np.float32(h8) / np.float32(ht), np.float32(w8) / np.float32(wt)
    flow12 = np.full((b_, ht, wt, 2), np.nan, np.float32)
    match = np.full((b_, ht, wt), np.nan, np.float32)
    n_in = n_out = 0
    for b, i0t, j0t in np.ndindex(b_, -(-ht // kcompose.TILE_H), -(-wt // kcompose.TILE_W)):
        i0t, j0t = i0t * kcompose.TILE_H, j0t * kcompose.TILE_W
        rows = np.arange(i0t, min(i0t + kcompose.TILE_H, ht))[:, None]
        cols = np.arange(j0t, min(j0t + kcompose.TILE_W, wt))[None, :]
        sr0, sr1 = _upsample_axis(i0t, h8, sh)[0], _upsample_axis(rows[-1, 0], h8, sh)[1] + 1
        sc0, sc1 = _upsample_axis(j0t, w8, sw)[0], _upsample_axis(cols[0, -1], w8, sw)[1] + 1
        staged = sr1 - sr0 <= kcompose.PATCH_H and sc1 - sc0 <= kcompose.PATCH_W
        wr0, wr1 = max(sr0 - kcompose.HALO_H, 0), min(sr1 + kcompose.HALO_H, h8)
        wc0, wc1 = max(sc0 - kcompose.HALO_W, 0), min(sc1 + kcompose.HALO_W, w8)
        whole = (0, h8, 0, w8)
        under = (sr0, sr1, sc0, sc1) if staged else whole
        fx8, fy8, a8 = (_patch(m, *under) for m in (flow8[b, ..., 0], flow8[b, ..., 1],
                                                    m12[b, ..., 0]))
        ay, ax = _upsample_axis(rows, h8, sh), _upsample_axis(cols, w8, sw)
        gx = np.clip(_upsampled(fx8, ay, ax, True) + _linspace_pm1(cols, wt), -1, 1)
        gy = np.clip(_upsampled(fy8, ay, ax, False) + _linspace_pm1(rows, ht), -1, 1)
        gx, gy = gx.astype(np.float32), gy.astype(np.float32)
        m = _upsampled(a8, ay, ax, False)
        f = np.zeros(gx.shape + (2,), np.float32)
        for y, x, w, ok in _corners(gx, gy, hc, wc):
            v = coarse[b, np.clip(y, 0, hc - 1), np.clip(x, 0, wc - 1)]
            f = np.where(ok[..., None], _fma(v, w[..., None], f), f)
        if cycle_match:  # a pixel's four corners from the patch when all lie inside
            near, far = _patch(m21[b, ..., 0], wr0, wr1, wc0, wc1), _patch(m21[b, ..., 0], *whole)
            cs = list(_corners(gx, gy, ht, wt))
            y0, x0 = cs[0][0], cs[0][1]
            ys = [_upsample_axis(y, h8, sh) for y in (y0, np.where(y0 + 1 < ht, y0 + 1, y0))]
            xs = [_upsample_axis(x, w8, sw) for x in (x0, np.where(x0 + 1 < wt, x0 + 1, x0))]
            inside = staged & (ys[0][0] >= wr0) & (ys[1][1] < wr1) & (xs[0][0] >= wc0) & (
                xs[1][1] < wc1)
            acc = np.zeros_like(gx)
            for k, (_, _, w, ok) in enumerate(cs):
                cy, cx = ys[k // 2], xs[k % 2]
                v = np.empty(gx.shape, np.float32)
                for sel, at in ((inside, near), (~inside, far)):
                    v[sel] = _upsampled(at, [a[sel] for a in cy], [a[sel] for a in cx], True)
                acc = np.where(ok, _fma(v, w, acc), acc)
            n_in, n_out = n_in + int(inside.sum()), n_out + int((~inside).sum())
            m = (m * acc).astype(np.float32)
        inb = (f >= -1).all(-1) & (f <= 1).all(-1)
        flow12[b, rows, cols] = f
        match[b, rows, cols] = m * inb
    return flow12, match, n_in, n_out


# (h8, w8, images, residual, out_hw, where match21's corners are read): the
# stride-8 maps' size and the residual's scale; a patch that fits, above the
# grid's size, corners far outside the patch, one output row, and a patch
# too wide to stage
COMPOSE_TILE_CASES = [(12, 17, 2, 0.04, None, "patch"), (12, 17, 1, 0.04, (101, 130), "patch"),
                      (12, 17, 1, 0.5, None, "both"), (1, 9, 3, 0.04, (1, 70), "patch"),
                      (4, 40, 1, 0.04, (10, 50), "map")]


@pytest.mark.parametrize("cycle_match", [True, False])
@pytest.mark.parametrize("h8,w8,b,residual,out_hw,reads", COMPOSE_TILE_CASES)
def test_compose_tail_tiles_emulated(rng, h8, w8, b, residual, out_hw, reads, cycle_match):
    """K8's tiling run in numpy against the plain version: every read of a
    staged patch lands inside it, the tiles cover the output once, and
    match21's corners are read from the patch, from the map (a large
    residual), or from the map only (no patch staged)."""
    flow8, m12, m21, coarse = _compose_inputs(rng, b=b, h8=h8, w8=w8, identity=False)
    flow8 = (flow8 * (residual / 0.04)).astype(np.float32)
    flow, match, n_in, n_out = _emulate_compose(flow8, m12, m21, coarse, cycle_match, out_hw)
    flow_r, match_r = compose_tail_ref(*map(t, (flow8, m12, m21, coarse)), cycle_match, out_hw)
    np.testing.assert_allclose(flow, flow_r.numpy(), atol=1e-5, rtol=0)
    off = ((flow_r.abs() - 1).abs() > 1e-5).all(dim=-1).numpy()
    np.testing.assert_allclose(match[off], match_r.numpy()[off], atol=1e-5, rtol=0)
    if cycle_match:
        assert (n_in > 0, n_out > 0) == {"patch": (True, False), "both": (True, True),
                                         "map": (False, True)}[reads]


def test_head_epilogues_ref_match_jax(rng):
    """Kernel 7's plain versions: models/heads.py:69-99 after conv4."""
    logits = (3 * rng.randn(2, 5, 6, 49)).astype(np.float32)
    p = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    gx, gy = j_corr_offset_grids(7)
    ref = jnp.stack([jnp.sum(p * gx, -1) / 6 * 2.0, jnp.sum(p * gy, -1) / 5 * 2.0], -1)
    close(flow_epilogue_ref(t(logits), 7), ref)
    close(match_epilogue_ref(t(logits[..., :1])), jax.nn.sigmoid(jnp.asarray(logits[..., :1])))


@pytest.mark.parametrize("k", [3, 5, 7])
def test_head_epilogues_ref_matches_jax_heads(rng, monkeypatch, k):
    """Kernel 7's plain version of a fine pass's three epilogues against
    JAX's `net_flow_coarse` and `net_matchability` after their trunks (each
    trunk replaced by seeded logits); match_down8 is the two sigmoids."""
    logits = {"flow": (3 * rng.randn(2, 5, 6, k * k)).astype(np.float32),
              "m12": (3 * rng.randn(2, 5, 6, 1)).astype(np.float32),
              "m21": (3 * rng.randn(2, 5, 6, 1)).astype(np.float32)}
    monkeypatch.setattr(jheads, "_trunk", lambda params, corr, train, axis_name: (
        jnp.asarray(logits[params]), {}))
    corr = jnp.zeros((2, 5, 6, k * k), jnp.float32)
    flow, m12, m21, match = head_epilogues_ref(
        t(logits["flow"]), t(logits["m12"]), t(logits["m21"]), k)
    close(flow, jheads.net_flow_coarse("flow", corr, up8=False, kernel_size=k)[0])
    close(m12, jheads.net_matchability("m12", corr, up8=False)[0])
    close(m21, jheads.net_matchability("m21", corr, up8=False)[0])
    assert torch.equal(match, torch.cat([m12, m21], dim=-1))


def test_cpu_tensors_take_the_plain_versions(rng):
    kernels.reset_launch_counts()
    x = t(rng.randn(1, 4, 5, 8).astype(np.float32))
    torch.testing.assert_close(correlation_volume(x, x, 3), correlation_volume_ref(x, x, 3))
    score = t(rng.randn(20, 9).astype(np.float32))
    for ours, ref in zip(mutual_argmax(score), mutual_argmax_ref(score)):
        torch.testing.assert_close(ours, ref)
    m1, m2, valid = (t(a) for a in _matches(rng, n=32))
    seed = torch.tensor([12345], dtype=torch.int64)
    (fit, record), (fit_ref, record_ref) = (
        ransac_fit(m1, m2, valid, 0.05, 16, seed=seed, record=True),
        ransac_fit_ref(m1, m2, valid, 0.05, 16, seed=seed))
    for ours, ref in zip((*fit, *record), (*fit_ref, *record_ref)):
        torch.testing.assert_close(ours, ref, equal_nan=True)
    ours, ref = (ransac_adaptive(m1, m2, valid, 0.05, 16, 8, 0.999, seed=seed, record=True),
                 ransac_adaptive_ref(m1, m2, valid, 0.05, 16, 8, 0.999, seed=seed))
    for a, b in zip((*ours[0], *ours[1:2], *ours[2]), (*ref[0], *ref[1:2], *ref[2])):
        torch.testing.assert_close(a, b, equal_nan=True)
    img, g = t(rng.rand(1, 6, 7, 3).astype(np.float32)), t(_warp_grid_with_border(rng, 1, 4, 5))
    torch.testing.assert_close(warp_sample(img, g), warp_sample_ref(img, g))
    args = tuple(map(t, _compose_inputs(rng)))
    for ours, ref in zip(compose_tail(*args, True), compose_tail_ref(*args, True)):
        torch.testing.assert_close(ours, ref)
    logits = t(rng.randn(1, 3, 4, 9).astype(np.float32))
    torch.testing.assert_close(flow_epilogue(logits, 3), flow_epilogue_ref(logits, 3))
    torch.testing.assert_close(match_epilogue(logits), match_epilogue_ref(logits))
    m12, m21 = logits[..., :1].contiguous(), logits[..., 1:2].contiguous()
    for ours, ref in zip(head_epilogues(logits, m12, m21, 3),
                         head_epilogues_ref(logits, m12, m21, 3)):
        torch.testing.assert_close(ours, ref)
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 13, 21, 40), (2, 9, 37, 256), (1, 5, 3, 6),
                                   (32, 28, 28, 256)])
def test_correlation_kernel_on_card(cuda, rng, shape):
    """K6 forward and its pair form against the plain versions: W narrower
    and wider than a 16-column tile, C = 40 and 256 (one and 8 channel
    chunks), C = 6 not a multiple of 4, the training shape. The pair is one
    launch, and its corr(y, x) is the kernel's own corr(y, x) bit for bit."""
    x = t(rng.randn(*shape).astype(np.float32)).to(cuda)
    y = t(rng.randn(*shape).astype(np.float32)).to(cuda)
    for k in (7, 3, 11, 1):
        xy = correlation_volume(x, y, k)
        torch.testing.assert_close(xy, correlation_volume_ref(x, y, k), atol=1e-4, rtol=0)
        kernels.reset_launch_counts()
        pair = correlation_pair(x, y, k)
        assert kernels.launch_counts()["correlation_pair"] == 1
        assert kernels.launch_counts()["correlation_volume"] == 0
        for got, want in zip(pair, correlation_pair_ref(x, y, k)):
            torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        assert torch.equal(pair[0], xy)
        assert torch.equal(pair[1], correlation_volume(y, x, k))
    with pytest.raises(ValueError):
        correlation_volume(x[..., :-1], y[..., 1:], 7)  # not contiguous
    with pytest.raises(ValueError):
        correlation_pair(x, y, 13)


def _same_bits(ours, ref):
    """Equal outputs, the floats bit for bit (the sign of zero and NaN)."""
    for x, y in zip(ours, ref):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("n_a,n_b", [(3000, 300), (3001, 301), (13065, 1200), (5000, 3000)])
def test_mutual_argmax_kernel_on_card(cuda, rng, n_a, n_b):
    """K2 against its plain version bit for bit: nB a multiple of 4 or not
    (16-byte or 4-byte loads), nA not a multiple of the row chunk, one
    column slice or several, a tie between rows of different chunks, NaN and
    inf scores, and the mask in the kernel with NaN and inf in masked
    columns."""
    from ransacflow_tpu_torch.kernels import matching as kmatch

    a, b, valid_b = _banks(rng, c=32, n_a=n_a, n_b=n_b)
    a[:, n_a - 7] = a[:, 12]  # rows 12 and nA - 7 lie in different chunks
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    n_chunks, rows, _, _ = kmatch.schedule(n_a, n_b, n_b % 4 == 0, n_sm)
    assert n_chunks > 1 and 12 // rows != (n_a - 7) // rows
    raw = (t(a).T @ t(b)).to(cuda)
    valid_b = t(valid_b).to(cuda)
    raw[5, 7] = raw[40, 11] = float("nan")  # unmasked and masked NaN
    raw[20, 9] = raw[30, 14] = float("inf")  # masked (NaN then) and unmasked inf
    valid_b[7] = valid_b[14] = True
    valid_b[9] = valid_b[11] = False
    masked = raw * valid_b.float()[None]
    for score, mask in ((masked, None), (raw, valid_b), (raw, None)):
        _same_bits(mutual_argmax(score, valid_b=mask), mutual_argmax_ref(score, valid_b=mask))
    got = mutual_argmax(raw, valid_b=valid_b)
    _same_bits(got, mutual_argmax(masked))  # the mask in the kernel or a pass before it
    assert got[0][3] == 12  # the tie across chunks: the lowest index


@pytest.mark.gpu
def test_ransac_score_kernel_on_card(cuda, rng):
    """Kernel 3 under injected sets, duplicates included, against its plain
    version: each hypothesis's count, and the winner."""
    m1, m2, valid = _matches(rng, n=1500)
    s = t(rng.randint(0, 1500, (3000, 4)).astype(np.int32))
    s[:5, 2] = s[:5, 3]
    m1, m2, valid, s = (x.to(cuda) for x in (t(m1), t(m2), t(valid), s))
    fit, record = ransac_fit(m1, m2, valid, 0.05, 3000, samples=s, record=True)
    fit_r, record_r = ransac_fit_ref(m1, m2, valid, 0.05, 3000, samples=s)
    assert (record.counts[:5] == 0).all() and torch.equal(record.sets, s)
    assert (record.counts == record_r.counts).float().mean() >= 0.999
    assert int(fit.num_inliers) == int(fit_r.num_inliers)
    assert torch.equal(fit.best_sample, fit_r.best_sample)
    torch.testing.assert_close(fit.H21, fit_r.H21, atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("structured", [True, False])
def test_ransac_adaptive_kernel_on_card(cuda, rng, structured):
    """Kernel 4 against its plain version on the same seed, the op under
    sync-debug 'error' (nothing reads back): one block, or all 12."""
    m1, m2, valid = _matches(rng, n=1200, inlier_frac=0.6 if structured else 0.0)
    m1, m2, valid = (x.to(cuda) for x in (t(m1), t(m2), t(valid)))
    gen = torch.Generator(device=cuda).manual_seed(0)
    seed = ransac.draw_seed(torch.Generator(device=cuda).manual_seed(0), cuda)  # the op's
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res, n_eval = ransac.ransac_homography_adaptive(m1, m2, valid, 0.05, n_iter=12000,
                                                        chunk=1024, generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref, n_eval_r, _ = ransac_adaptive_ref(m1, m2, valid, 0.05, 12000, 1024, 0.999, seed=seed)
    assert bool(res.found) and int(n_eval) == int(n_eval_r)
    assert int(n_eval) == (1 if structured else 12) * 1024
    assert int(res.num_inliers) == int(ref.num_inliers)
    torch.testing.assert_close(res.best_sample, ref.best_sample)
    torch.testing.assert_close(res.H21, ref.H21, atol=1e-4, rtol=0)


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
@pytest.mark.parametrize("shape", [(2, 13, 17), (1, 60, 80)])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_head_epilogues_kernel_on_card(cuda, rng, shape, k):
    """K7's fused launch, a fine pass's three epilogues, against its plain
    version: one launch a call, match_down8 the two sigmoids bit for bit."""
    ins = [t((3 * rng.randn(*shape, c)).astype(np.float32)).to(cuda) for c in (k * k, 1, 1)]
    kernels.reset_launch_counts()
    flow, m12, m21, match = head_epilogues(*ins, k)
    assert kernels.launch_counts()["head_epilogues"] == 1
    flow_r, m12_r, m21_r, match_r = head_epilogues_ref(*ins, k)
    torch.testing.assert_close(flow, flow_r, atol=1e-5, rtol=0)
    for ours, ref in ((m12, m12_r), (m21, m21_r), (match, match_r)):
        torch.testing.assert_close(ours, ref, atol=1e-6, rtol=0)
    assert torch.equal(match, torch.cat([m12, m21], dim=-1))


@pytest.mark.gpu
@pytest.mark.parametrize("cycle_match", [True, False])
def test_compose_tail_kernel_on_card(cuda, rng, cycle_match):
    """K8 against its plain version at the coarse grid's size (out_hw None
    bit for bit the same as out_hw equal to it) and across resolutions,
    above and below the 40 x 56 coarse grid; and at the tiling's cases
    (`COMPOSE_TILE_CASES`: sizes that are not multiples of the tile, one
    output row, three images, match21 corners far outside the staged patch,
    a patch too wide to stage), each call deterministic."""
    for identity in (True, False):
        args = [x.to(cuda) for x in map(t, _compose_inputs(rng, b=2, identity=identity))]
        for out_hw in (None, (47, 61), (24, 33), (40, 56)):
            flow, match = compose_tail(*args, cycle_match, out_hw)
            flow_r, match_r = compose_tail_ref(*args, cycle_match, out_hw)
            assert flow.shape == flow_r.shape and match.shape == match_r.shape
            torch.testing.assert_close(flow, flow_r, atol=1e-5, rtol=0)
            # the in-bounds mask is a step at |flow12| = 1: compare off it
            off = ((flow_r.abs() - 1).abs() > 1e-5).all(dim=-1)
            torch.testing.assert_close(match[off], match_r[off], atol=1e-5, rtol=0)
            assert off.float().mean() > 0.8
        default, same = compose_tail(*args, cycle_match), compose_tail(*args, cycle_match, (40, 56))
        for a, b in zip(default, same):
            assert torch.equal(a, b)
    for h8, w8, b, residual, out_hw, _ in COMPOSE_TILE_CASES:
        flow8, m12, m21, coarse = _compose_inputs(rng, b=b, h8=h8, w8=w8, identity=False)
        flow8 = (flow8 * (residual / 0.04)).astype(np.float32)
        args = [x.to(cuda) for x in map(t, (flow8, m12, m21, coarse))]
        for hw in (out_hw, None):
            got = compose_tail(*args, cycle_match, hw)
            flow_r, match_r = compose_tail_ref(*args, cycle_match, hw)
            torch.testing.assert_close(got[0], flow_r, atol=1e-5, rtol=0)
            off = ((flow_r.abs() - 1).abs() > 1e-5).all(dim=-1)
            torch.testing.assert_close(got[1][off], match_r[off], atol=1e-5, rtol=0)
            for a, again in zip(got, compose_tail(*args, cycle_match, hw)):
                assert torch.equal(a, again)
        same = compose_tail(*args, cycle_match, coarse.shape[1:3])
        for a, again in zip(compose_tail(*args, cycle_match), same):
            assert torch.equal(a, again)


def _forward_only_calls(rng, device):
    """(name, call) of every forward-only wrapper on inputs that require grad."""
    m1, m2, valid = _matches(rng, n=32)
    m1, m2, valid = (t(a).to(device) for a in (m1, m2, valid))
    seed = torch.tensor([7], dtype=torch.int64, device=device)
    f8, m12, m21, coarse = (t(a).to(device) for a in _compose_inputs(rng))
    score = t(rng.randn(20, 9).astype(np.float32)).to(device)
    img = t(rng.rand(1, 16, 20, 3).astype(np.float32)).to(device)
    feat = t(rng.randn(1, 5, 6, 8).astype(np.float32)).to(device)
    logits = t(rng.randn(1, 5, 7, 9).astype(np.float32)).to(device)
    g = lambda x: x.clone().requires_grad_()  # noqa: E731
    return [("mutual_argmax", lambda: mutual_argmax(g(score))),
            ("correlation_pair", lambda: correlation_pair(feat, g(feat), 3)),
            ("ransac_fit", lambda: ransac_fit(g(m1), m2, valid, 0.05, 16, seed=seed)),
            ("ransac_adaptive", lambda: ransac_adaptive(m1, g(m2), valid, 0.05, 16, 8, 0.999,
                                                        seed=seed)),
            ("compose_tail", lambda: compose_tail(g(f8), m12, m21, coarse, True)),
            ("head_epilogues", lambda: head_epilogues(logits, g(m12), m21, 3)),
            ("device_pyramid", lambda: pyramid.device_pyramid(g(img), [(8, 10)])),
            ("mutual_argmax relaxed", lambda: mutual_argmax(g(score), 1, 3)),
            ("anchor_resample_feats", lambda: anchor_resample_feats(g(img), 5, 7)),
            ("ppm_pool", lambda: ppm_pool(g(img)))]


def test_forward_only_wrappers_raise_under_grad(rng):
    """K1, K2 (exact and relaxed), K3, K4, K6's pair form, K7's fused
    epilogues, K8, K12 and K13 have no backward:
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


SERVING_PYRAMID = ((960, 1280), ((800, 1056), (640, 848), (480, 640), (400, 528),
                                 (320, 416), (240, 320)))
# odd sizes: an upscale, one identity axis each way, 4x down, a 1-pixel side
ODD_PYRAMIDS = (((37, 53), ((45, 61), (37, 20), (9, 53), (10, 14), (1, 7))),
                ((96, 128), ((80, 106), (48, 64), (24, 32), (120, 160), (96, 64))))


def _blocks(plan):
    """(scale index, scale fields, strip, band, (q0, nq), (lo, n)) of every
    block of a `pyramid.schedule`, in launch order."""
    for s, m in enumerate(plan["meta"].tolist()):
        f = dict(zip(pyramid.META, m))
        n_bands = -(-f["h"] // f["band_rows"])
        for blk in range(f["n_strips"] * n_bands):
            strip, band = blk % f["n_strips"], blk // f["n_strips"]
            yield (s, f, strip, band, plan["strips"][f["strip"] + 2 * strip:][:2],
                   plan["bands"][f["band"] + 2 * band:][:2])


def _block_taps(plan, f):
    """The scale's row and column taps as the kernel reads them."""
    def axis(idx, w_off, t, n):
        return (plan["starts"][idx:idx + n], plan["counts"][idx:idx + n],
                plan["weights"][w_off:w_off + n * t].reshape(n, t))
    return (axis(f["row_idx"], f["row_w"], f["row_t"], f["h"]),
            axis(f["col_idx"], f["col_w"], f["col_t"], f["w"]))


@pytest.mark.parametrize("hw,shapes", [SERVING_PYRAMID, *ODD_PYRAMIDS])
def test_pyramid_schedule_stages_every_tap(hw, shapes):
    """K1's schedule: each block's staged input rows [lo, lo + n) hold every
    vertical tap of its band's rows, its staged floats [q0, q0 + nq) every
    horizontal tap of its strip's columns, the taps are the plain version's,
    the blocks tile every scale once, and a block's shared memory fits the
    budget that puts 4 blocks on an SM (and so the H100's 227 KB)."""
    H, W = hw
    plan = pyramid.schedule(H, W, shapes)
    assert 0 < plan["smem"] <= pyramid.BLOCK_SMEM <= 227 * 1024
    covered = {s: np.zeros((h, w), np.int32) for s, (h, w) in enumerate(shapes)}
    for s, f, strip, band, (q0, nq), (lo, n) in _blocks(plan):
        (rs, rc, rw), (cs, cc, cw) = _block_taps(plan, f)
        assert n <= H - lo and q0 % 4 == 0 and 0 <= nq <= f["stride"] and q0 + nq <= 3 * W
        assert pyramid._smem(n, f["band_rows"], f["stride"], f["strip_w"], f["col_t"],
                             f["row_t"]) <= plan["smem"]
        ys = range(band * f["band_rows"], min((band + 1) * f["band_rows"], f["h"]))
        xs = range(strip * f["strip_w"], min((strip + 1) * f["strip_w"], f["w"]))
        for y in ys:
            assert rc[y] == 0 or lo <= rs[y] and rs[y] + rc[y] <= lo + n, (f, y)
        for x in xs:
            assert cc[x] == 0 or q0 <= 3 * cs[x] and 3 * (cs[x] + cc[x]) <= q0 + nq, (f, x)
        covered[s][ys.start:ys.stop, xs.start:xs.stop] += 1
    assert all((c == 1).all() for c in covered.values())
    for s, (h, w) in enumerate(shapes):
        f = dict(zip(pyramid.META, plan["meta"][s].tolist()))
        for (st, ct, wt), (st_ref, ct_ref, wt_ref) in zip(_block_taps(plan, f),
                                                          (pyramid.taps(H, h), pyramid.taps(W, w))):
            np.testing.assert_array_equal(st, st_ref)
            np.testing.assert_array_equal(ct, ct_ref)
            np.testing.assert_array_equal(wt, wt_ref)


def _emulate_pyramid(img, shapes):
    """A numpy transliteration of `csrc/pyramid.cu`'s index math: each block
    of the schedule stages its rows (NaN where nothing was staged) and
    computes its band as the kernel does. Returns the non-identity scales of
    one (H, W, 3) image."""
    H, W, _ = img.shape
    todo = [s for s in shapes if s != (H, W)]
    plan = pyramid.schedule(H, W, todo)
    flat = img.reshape(H, W * 3)
    outs = [np.full((h, w * 3), np.nan, np.float32) for h, w in todo]
    for s, f, strip, band, (q0, nq), (lo, n) in _blocks(plan):
        (rs, rc, rw), (cs, cc, cw) = _block_taps(plan, f)
        rows = np.full((n, f["stride"]), np.nan, np.float32)
        rows[:, :nq] = flat[lo:lo + n, q0:q0 + nq]
        y0, x0 = band * f["band_rows"], strip * f["strip_w"]
        ny, nx = min(f["band_rows"], f["h"] - y0), min(f["strip_w"], f["w"] - x0)
        tmp = np.zeros((ny, nq), np.float32)
        for r in range(ny):
            y = y0 + r
            for t_ in range(rc[y]):
                tmp[r] += rw[y, t_] * rows[rs[y] - lo + t_, :nq]
        for x in range(x0, x0 + nx):
            for ch in range(3):
                src = 3 * cs[x] - q0 + ch + 3 * np.arange(cc[x])
                outs[s][y0:y0 + ny, 3 * x + ch] = (tmp[:, src] * cw[x, :cc[x]]).sum(1)
    return [o.reshape(h, w, 3) for o, (h, w) in zip(outs, todo)]


def test_pyramid_kernel_index_math_emulated(rng):
    """K1's index math (strips, bands, the staged rows and spans), run in
    numpy over the schedule, against the plain version: serving ratios at a
    tenth of the size, an upscale, one identity axis and 4x down."""
    img = rng.rand(96, 128, 3).astype(np.float32)
    shapes = [(80, 106), (64, 85), (48, 64), (40, 53), (32, 43), (24, 32), (120, 160),
              (96, 64), (30, 128), (37, 5)]
    got = _emulate_pyramid(img, shapes)
    want = pyramid.device_pyramid_ref(t(img[None]), shapes)
    for g_, w_ in zip(got, want):
        assert not np.isnan(g_).any()
        np.testing.assert_allclose(g_, w_[0].numpy(), atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_forward_only_wrappers_raise_under_grad_on_card(cuda, rng):
    for name, call in _forward_only_calls(rng, cuda):
        with pytest.raises(RuntimeError, match="no backward"):
            call()


@pytest.mark.gpu
@pytest.mark.parametrize("hw,shapes", [
    # the serving ratios (0.83 down to 4x down, 24 taps) at a quarter of the size
    ((240, 320), ((240, 320), (200, 264), (160, 212), (120, 160), (100, 132), (80, 104),
                  (60, 80))),
    *ODD_PYRAMIDS])
def test_pyramid_kernel_on_card(cuda, rng, hw, shapes):
    """K1 against its plain version, a batch of 4, every scale in one
    launch; odd sizes take the 4-byte copies (W * 3 not a multiple of 4)."""
    img = t(rng.rand(4, *hw, 3).astype(np.float32)).to(cuda)
    kernels.reset_launch_counts()
    got = pyramid.device_pyramid(img, shapes)
    assert kernels.launch_counts()["lanczos_pyramid"] == 1  # every scale, one launch
    for g, r, shape in zip(got, pyramid.device_pyramid_ref(img, shapes), shapes):
        assert g.shape == r.shape and g.is_contiguous()
        if tuple(shape) == tuple(hw):
            assert g is img
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(223, 223), (24, 31), (112, 112), (2, 3), (3, 2), (4, 5),
                                (5, 4), (2, 2), (3, 3), (31, 24), (112, 223), (223, 112)])
@pytest.mark.parametrize("channels", [5, 64])
@pytest.mark.parametrize("channels_last", [False, True])
def test_blur_pool_kernels_on_card(cuda, rng, hw, channels, channels_last):
    """K9 forward and backward against autograd of the plain version; the
    backward's closed-form taps at every edge case: odd and even sizes from
    2 up, the scalar (C = 5) and float4 (C = 64, channels-last) paths."""
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = t(rng.randn(2, channels, *hw).astype(np.float32)).to(cuda).contiguous(memory_format=fmt)
    filt = binomial_filter(channels, 3, cuda)
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
@pytest.mark.parametrize("shape", [(2, 13, 21, 40), (2, 9, 37, 256), (1, 5, 3, 6)])
def test_correlation_backward_kernel_on_card(cuda, rng, shape):
    """K6's backward against autograd of the plain version: C = 40 and 256
    (one and two channel chunks, C = 6 not a multiple of 4), W narrower
    than one 32-column tile and wider, k up to 11, both cotangents in one
    launch and each side alone."""
    x = t(rng.randn(*shape).astype(np.float32)).to(cuda)
    y = t(rng.randn(*shape).astype(np.float32)).to(cuda)
    for k in (7, 3, 11, 1):
        g = torch.randn((*shape[:3], k * k), device=cuda)
        xk, yk, xr, yr = (a.clone().requires_grad_() for a in (x, y, x, y))
        kernels.reset_launch_counts()
        correlation_volume(xk, yk, k).backward(g)
        assert kernels.launch_counts()["correlation_volume_bwd"] == 1
        correlation_volume_ref(xr, yr, k).backward(g)
        torch.testing.assert_close(xk.grad, xr.grad, atol=1e-4, rtol=0)
        torch.testing.assert_close(yk.grad, yr.grad, atol=1e-4, rtol=0)
        # one side only: the other gets no cotangent
        for side in (0, 1):
            ins = [x, y]
            ins[side] = ins[side].clone().requires_grad_()
            correlation_volume(*ins, k).backward(g)
            want = (xr, yr)[side].grad
            torch.testing.assert_close(ins[side].grad, want, atol=1e-4, rtol=0)


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


def test_ssim_kernel_taps_are_the_plain_taps():
    """K10's taps are literals in its source (immediates in the unrolled
    tap loops): they equal `gaussian_window()` and `BOX_TAP` bit for bit."""
    import pathlib
    import re

    src = (pathlib.Path(kssim.__file__).parents[1] / "csrc" / "ssim.cu").read_text()
    body = src[src.index("float gauss_tap(int t)"):]
    body = body[:body.index("}")]
    by_distance = [np.float32(float.fromhex(h)) for h in re.findall(r"(0x[0-9a-f.]+p-\d+)f", body)]
    g = kssim.gaussian_window()
    assert len(by_distance) == 6
    np.testing.assert_array_equal(by_distance, g[5:])
    np.testing.assert_array_equal(g, g[::-1])  # the source folds t to |t - 5|
    box = re.search(r"kBox = (0x[0-9a-f.]+p-\d+)f", src).group(1)
    assert np.float32(float.fromhex(box)) == kssim.BOX_TAP


def _emulate_ssim_staging(flat, b, h, w, c, y0, x0):
    """One tile's staged rows as K10's `stage_tile` writes them and its
    passes read them, in numpy. Each row's run (the pixel (b, y0 - 5 + r,
    x0 - 5) on) starts at float off = ((x0 - 5) c) & 3 of its row. W a
    multiple of 4: the row's window of whole float4s, its part inside the
    image one bulk copy (16-byte aligned ends), zeros elsewhere; else float
    by float. Returns the (42, 42, c) staged tile."""
    halo = kssim.WINDOW // 2
    in_h, in_w = kssim.TILE_H + 2 * halo, kssim.TILE_W + 2 * halo
    stride = (in_w * c + 6) // 4 * 4  # kImgStride (c = 3), kMapStride (c = 1)
    off = ((x0 - halo) * c) & 3
    out = np.full((in_h, in_w, c), np.nan, np.float32)
    for r in range(in_h):
        y = y0 - halo + r
        lo, hi = (b * h + y) * w * c, (b * h + y + 1) * w * c
        row = np.full(stride, np.nan, np.float32)
        if w % 4 == 0:
            win = lo + (x0 - halo) * c - off
            assert win % 4 == 0
            first = max(lo - win, 0) if 0 <= y < h else stride
            last = min(hi - win, stride) if 0 <= y < h else stride
            row[:] = 0
            if last > first:
                assert first % 4 == 0 and (last - first) * 4 % 16 == 0
                assert 0 <= win + first and win + last <= flat.size
                row[first:last] = flat[win + first:win + last]
        else:
            for k in range(in_w * c):
                a = lo + (x0 - halo) * c + k
                row[off + k] = flat[a] if 0 <= y < h and lo <= a < hi else 0
        assert off + in_w * c <= stride
        out[r] = row[off:off + in_w * c].reshape(in_w, c)
    return out


@pytest.mark.parametrize("b,h,w,c", [(2, 37, 70, 3), (1, 7, 9, 3), (3, 20, 23, 1),
                                     (2, 64, 64, 3), (2, 33, 68, 1)])
def test_ssim_staging_emulated(rng, b, h, w, c):
    """K10's staging index math (the runs' offset, the bulk copies' windows,
    zeros outside the image) gives every tile its zero-padded rows, at
    widths that are and are not multiples of 4, images smaller than the
    halo, and the first and last image of the batch (the ends of the
    array)."""
    img = rng.rand(b, h, w, c).astype(np.float32)
    halo = kssim.WINDOW // 2
    for bi in {0, b - 1}:
        padded = np.pad(img[bi], ((halo, halo + kssim.TILE_H), (halo, halo + kssim.TILE_W),
                                  (0, 0)))
        for y0 in range(0, h, kssim.TILE_H):
            for x0 in range(0, w, kssim.TILE_W):
                got = _emulate_ssim_staging(img.ravel(), bi, h, w, c, y0, x0)
                want = padded[y0:y0 + kssim.TILE_H + 2 * halo, x0:x0 + kssim.TILE_W + 2 * halo]
                np.testing.assert_array_equal(got, want)
    # the saved partials' planes are plane_len floats apart, a multiple of
    # 4: a row lies alike in every plane
    plane = kssim.plane_len(b, h, w)
    assert plane % 4 == 0 and plane >= b * h * w


SSIM_CARD_SHAPES = [(2, 20, 23), (1, 7, 9), (3, 37, 70), (1, 9, 12), (2, 224, 224)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SSIM_CARD_SHAPES)
def test_masked_ssim_kernels_on_card(cuda, rng, shape):
    """K10 forward (a two-pass reduction: deterministic), with and without
    the saved partials, and backward in img1 against the plain version's
    autograd: widths that are and are not multiples of 4, an image smaller
    than the halo, one image whose mask is all below the threshold; the
    saved partials against `ssim_partials_ref`; one launch per call of each
    wrapper; two backward calls equal bit for bit."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):  # the plain version in fp32
        _check_masked_ssim_on_card(cuda, rng, *shape)


def _check_masked_ssim_on_card(cuda, rng, b, h, w):
    img1, img2 = (t(rng.rand(b, h, w, 3).astype(np.float32)).to(cuda) for _ in range(2))
    match = t(rng.rand(b, h, w, 1).astype(np.float32)).to(cuda)
    match[0] = 0.0  # an image with no valid pixel: its mask all below the threshold
    ik, ir = img1.clone().requires_grad_(), img1.clone().requires_grad_()
    kernels.reset_launch_counts()
    lk = masked_ssim_loss(ik, img2, match)
    assert kernels.launch_counts()["masked_ssim"] == 1
    lr = masked_ssim_loss_ref(ir, img2, match)
    torch.testing.assert_close(lk, lr, atol=0, rtol=1e-5)
    assert masked_ssim_loss(img1, img2, match).item() == lk.item()  # deterministic
    assert masked_ssim_loss(ik, img2, match).item() == lk.item()
    _, sums, abc = kssim.masked_ssim_forward(img1, img2, match, True)
    abc_ref, mask_sum = kssim.ssim_partials_ref(img1, img2, match)
    got = abc.view(kssim.N_PLANES, -1)[:, :b * h * w].view(abc_ref.shape)
    # per-pixel fp32 algebra of the same blurred maps, summed in another order
    torch.testing.assert_close(got, abc_ref, atol=1e-5 * float(abc_ref.abs().max()), rtol=0)
    torch.testing.assert_close(sums[1], mask_sum, atol=0, rtol=1e-5)
    g = torch.tensor(2.5, device=cuda)
    kernels.reset_launch_counts()
    (d_k,) = torch.autograd.grad(lk, ik, g, retain_graph=True)
    assert kernels.launch_counts()["masked_ssim_bwd"] == 1
    (d_k2,) = torch.autograd.grad(lk, ik, g, retain_graph=True)
    assert torch.equal(d_k, d_k2)  # deterministic: no atomics
    (d_r,) = torch.autograd.grad(lr, ir, g)
    torch.testing.assert_close(d_k, d_r, atol=1e-5 * float(d_r.abs().max()), rtol=0)
    with pytest.raises(RuntimeError, match="img2"):
        masked_ssim_loss(img1, img2.clone().requires_grad_(), match)


def _close_bf16(got, want):
    """A bf16 output against its plain version's fp32 result rounded to bf16:
    within one bf16 spacing (the kernel's and the plain version's fp32 sums
    may round to neighbouring bf16 values), and bf16 itself."""
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.to(torch.bfloat16).float(), rtol=2**-7,
                               atol=1e-5)


@pytest.mark.gpu
def test_bf16_inputs_launch_the_kernels_on_card(cuda, rng):
    """The boundary casts of the eval and training policies: each wrapper of
    a bf16 path (K2, K6 and its pair form, K7, K8, K9, K12), handed bf16
    CUDA tensors, launches its kernel (and its backward kernel) and matches
    its plain version run on the fp32 upcast of the same inputs; the
    cotangents come back in bf16. K2's answer is its plain version's bit for
    bit (the upcast is exact)."""
    b16 = torch.bfloat16

    def on(a):
        return t(a).to(cuda).to(b16)

    def launched(name, fn):
        kernels.reset_launch_counts()
        out = fn()
        assert kernels.launch_counts()[name] >= 1, name
        return out

    x, y = on(rng.randn(1, 9, 21, 256)), on(rng.randn(1, 9, 21, 256))
    for got, want in zip(launched("correlation_pair", lambda: correlation_pair(x, y, 7)),
                         correlation_pair_ref(x.float(), y.float(), 7)):
        _close_bf16(got, want)
    xg, xr = x.clone().requires_grad_(), x.float().requires_grad_()
    out = launched("correlation_volume", lambda: correlation_volume(xg, y, 7))
    ref = correlation_volume_ref(xr, y.float(), 7)
    _close_bf16(out, ref)
    g = on(rng.randn(*out.shape))
    launched("correlation_volume_bwd", lambda: out.backward(g))
    ref.backward(g.float())
    _close_bf16(xg.grad, xr.grad)

    logits, m12, m21 = on(rng.randn(2, 7, 9, 49)), on(rng.randn(2, 7, 9, 1)), \
        on(rng.randn(2, 7, 9, 1))
    for got, want in zip(launched("head_epilogues", lambda: head_epilogues(logits, m12, m21)),
                         head_epilogues_ref(logits.float(), m12.float(), m21.float())):
        _close_bf16(got, want)
    for fn, ref_fn, arg in ((flow_epilogue, flow_epilogue_ref, logits),
                            (match_epilogue, match_epilogue_ref, m12)):
        ag, ar = arg.clone().requires_grad_(), arg.float().requires_grad_()
        out = launched("head_epilogues", lambda: fn(ag))
        ref = ref_fn(ar)
        _close_bf16(out, ref)
        g = on(rng.randn(*out.shape))
        launched("head_epilogues_bwd", lambda: out.backward(g))
        ref.backward(g.float())
        _close_bf16(ag.grad, ar.grad)

    a, bnk, valid_b = _banks(rng, c=32, n_a=3001, n_b=301)
    score = (t(a).T @ t(bnk)).to(cuda).to(b16)  # bf16 rounding makes ties common
    got = launched("mutual_argmax", lambda: mutual_argmax(score, 1, 7))
    want = mutual_argmax_ref(score.float(), 1, 7)
    for gi, wi in zip(got[:3], want[:3]):
        assert torch.equal(gi, wi)
    assert got[3].dtype == b16 and torch.equal(got[3].float(), want[3])

    fmap = on(rng.randn(1, 13, 17, 64))
    _close_bf16(launched("anchor_resample", lambda: anchor_resample_feats(fmap, 5, 7)),
                anchor_resample_feats_ref(fmap.float(), 5, 7))

    flow8, c12, c21, coarse = _compose_inputs(rng, b=1, identity=False)
    args = (on(flow8), on(c12), on(c21), t(coarse).to(cuda))
    for cycle_match in (True, False):
        flow, match = launched("compose_tail", lambda: compose_tail(*args, cycle_match))
        flow_r, match_r = compose_tail_ref(*(a.float() for a in args), cycle_match)
        assert flow.dtype == torch.float32
        torch.testing.assert_close(flow, flow_r, atol=1e-5, rtol=0)
        if cycle_match:  # match12 times the fp32 sample: fp32, as in JAX
            torch.testing.assert_close(match, match_r, atol=1e-5, rtol=0)
        else:
            _close_bf16(match, match_r)

    xb = on(rng.randn(2, 64, 13, 18)).contiguous(memory_format=torch.channels_last)
    filt = binomial_filter(64, 3, cuda).to(b16)
    xg, xr = xb.clone().requires_grad_(), xb.float().requires_grad_()
    out = launched("blur_pool", lambda: blur_pool(xg, filt))
    ref = blur_pool_ref(xr, filt.float())
    _close_bf16(out, ref)
    g = on(rng.randn(*out.shape))
    launched("blur_pool_bwd", lambda: out.backward(g))
    ref.backward(g.float())
    _close_bf16(xg.grad, xr.grad)
