"""Parity of the PyTorch port's multi-homography loop with the JAX package,
on the CPU.

Adaptive RANSAC (kernel 4's plain version) is fed the reference's per-block
draws (`_sample_minimal_sets(fold_in(key, i))` mapped through the stable
valid-first order); `CoarseAligner.get_coarse` and the host loop replay
JAX's draws as injected samples; the device-resident loop, whose draws come
from a torch generator, is held to the host loop and to JAX's loop by its
count and its first homography. Weights are JAX's init trees, carried over
by `convert`; images are the translated blocky pair of tests/test_pipeline.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image
from torch.utils._python_dispatch import TorchDispatchMode

from ransacflow_tpu.models import init_resnet50_layer3 as j_init_resnet
from ransacflow_tpu.ops import grid_sample as j_grid_sample
from ransacflow_tpu.ops import ransac as jransac
from ransacflow_tpu.ops import warp_grid as j_warp_grid
from ransacflow_tpu.pipeline import CoarseAligner as JCoarseAligner
from ransacflow_tpu.pipeline import coarse as jcoarse
from ransacflow_tpu.pipeline import init_alignment_params as j_init_align
from ransacflow_tpu.pipeline import multihomo as jmultihomo
from ransacflow_tpu.pipeline.fine import fine_features as j_fine_features
from ransacflow_tpu_torch.models import convert
from ransacflow_tpu_torch.ops import ransac
from ransacflow_tpu_torch.pipeline import CoarseAligner, coarse, multihomo

H_IMG = W_IMG = 256
BORDER = 48
N_ITER = 2000
ATOL_H21 = 1e-4   # fp32 4-point solves in two libraries
ATOL_MAPS = 1e-4  # fp32 conv stacks in two libraries (~20 convolutions)


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


def t(a):
    return torch.from_numpy(np.array(a))


def _translated_pair(rng, dx_px=32, dy_px=16):
    """Blocky source and its translation (tests/test_pipeline.py:36)."""
    base = (rng.rand(H_IMG // 4, W_IMG // 4, 3) > 0.5).astype(np.float32)
    src_arr = np.kron(base, np.ones((4, 4, 1), np.float32))
    src = Image.fromarray((src_arr * 255).astype(np.uint8))
    src_arr = np.asarray(src, np.float32) / 255.0
    h_true = np.array([[1, 0, 2 * dx_px / W_IMG], [0, 1, 2 * dy_px / H_IMG],
                       [0, 0, 1]], np.float32)
    g = j_warp_grid(jnp.asarray(h_true)[None], H_IMG, W_IMG)
    tgt_arr = np.asarray(j_grid_sample(jnp.asarray(src_arr)[None], g))[0]
    tgt = Image.fromarray((np.clip(tgt_arr, 0, 1) * 255).astype(np.uint8))
    return src, tgt, h_true


def _border_mask():
    m = np.ones((H_IMG, W_IMG), np.float32)
    m[BORDER:-BORDER, BORDER:-BORDER] = 0
    return m


def _h_error(h_a, h_b, n=64):
    """Mean distance between the maps of two homographies on random points."""
    pts = np.random.RandomState(0).rand(n, 2) * 1.2 - 0.6
    p = np.concatenate([pts, np.ones((n, 1))], 1)

    def apply(h):
        q = p @ np.asarray(h, np.float64).T
        return q[:, :2] / q[:, 2:]

    return np.abs(apply(h_a) - apply(h_b)).mean()


def _ransac_problem(rng, n=300, inlier_frac=0.7, noise=0.003):
    """tests/test_matching_ransac.py:109, in numpy."""
    H = np.eye(3) + rng.randn(3, 3) * 0.15
    H[2, :2] *= 0.1
    m2 = (rng.rand(n, 2) * 1.6 - 0.8).astype(np.float32)
    q = np.concatenate([m2, np.ones((n, 1), np.float32)], 1) @ H.T.astype(np.float32)
    m1 = (q[:, :2] / q[:, 2:]).astype(np.float32)
    n_out = int(n * (1 - inlier_frac))
    m1[:n_out] = rng.rand(n_out, 2) * 2 - 1
    m1 += rng.randn(n, 2).astype(np.float32) * noise
    ones = np.ones((n, 1), np.float32)
    return np.concatenate([m1, ones], 1), np.concatenate([m2, ones], 1), n_out


def _reference_block_draws(key, valid, n_iter, chunk):
    """JAX's per-block minimal sets of `ransac_homography_adaptive` under
    `key`, as match indices: block i draws under fold_in(key, i)."""
    n_valid = jnp.sum(jnp.asarray(valid).astype(jnp.int32))
    order = np.argsort(~valid, kind="stable")
    blocks = []
    for i in range(-(-n_iter // chunk)):
        raw, _ = jransac._sample_minimal_sets(jax.random.fold_in(key, i), n_valid,
                                              4, chunk)
        blocks.append(order[np.asarray(raw)])
    return np.concatenate(blocks).astype(np.int32)


def _adaptive_case(rng, case):
    if case == "clean":  # 70% inliers: stops after one block
        m1, m2, _ = _ransac_problem(rng)
        return m1, m2, np.ones(len(m1), bool), 0.05, 50000, 1024
    if case == "structureless":  # never meets the bound: runs to the cap
        n = 300
        ones = np.ones((n, 1), np.float32)
        m1 = np.concatenate([rng.rand(n, 2) * 2 - 1, ones], 1).astype(np.float32)
        m2 = np.concatenate([rng.rand(n, 2) * 2 - 1, ones], 1).astype(np.float32)
        return m1, m2, np.ones(n, bool), 0.003, 4096, 1024
    m = np.zeros((10, 3), np.float32)  # degenerate: < 4 valid matches
    m[:, 2] = 1.0
    valid = np.zeros(10, bool)
    valid[:3] = True
    return m, m.copy(), valid, 0.05, 1024, 512


@pytest.mark.parametrize("case", ["clean", "structureless", "degenerate"])
def test_ransac_adaptive_matches_jax_under_its_draws(rng, case):
    m1, m2, valid, tol, n_iter, chunk = _adaptive_case(rng, case)
    key = jax.random.PRNGKey(0)
    ref, ref_eval = jransac.ransac_homography_adaptive(
        key, jnp.asarray(m1), jnp.asarray(m2), jnp.asarray(valid), tolerance=tol,
        n_iter=n_iter, chunk=chunk)
    samples = _reference_block_draws(key, valid, n_iter, chunk)
    ours, ours_eval = ransac.ransac_homography_adaptive(
        t(m1), t(m2), t(valid), tol, n_iter=n_iter, chunk=chunk,
        injected_samples=t(samples))
    assert int(ours_eval) == int(ref_eval)
    assert int(ours.num_inliers) == int(ref.num_inliers)
    assert bool(ours.found) == bool(ref.found)
    np.testing.assert_array_equal(ours.best_sample.numpy(), np.asarray(ref.best_sample))
    np.testing.assert_allclose(ours.H21.numpy(), np.asarray(ref.H21), atol=ATOL_H21)
    np.testing.assert_array_equal(ours.inlier_mask.numpy(), np.asarray(ref.inlier_mask))
    expected = {"clean": (chunk, True), "structureless": (4096, True),
                "degenerate": (n_iter, False)}[case]
    assert (int(ours_eval), bool(ours.found)) == expected


def test_ransac_adaptive_distributional_parity(rng):
    """tests/test_matching_ransac.py:301 for the port's own draws: early
    exit changes how much work finds the model, not what is found."""
    m1, m2, n_out = _ransac_problem(rng, n=240, inlier_frac=0.55)
    valid = torch.ones(len(m1), dtype=torch.bool)
    tgt = np.concatenate([m2[n_out:, :2], np.ones((len(m1) - n_out, 1))], 1)

    def h_gap(ha, hb):
        ea, eb = tgt @ ha.numpy().T.astype(np.float64), tgt @ hb.numpy().T.astype(np.float64)
        return np.linalg.norm(ea[:, :2] / ea[:, 2:] - eb[:, :2] / eb[:, 2:], axis=1).max()

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    counts_fx, counts_ad, gaps_ff, gaps_fa = [], [], [], []
    for seed in range(8):
        fx = ransac.ransac_homography(t(m1), t(m2), valid, 0.05, n_iter=4096,
                                      generator=gen(seed))
        fx2 = ransac.ransac_homography(t(m1), t(m2), valid, 0.05, n_iter=4096,
                                       generator=gen(200 + seed))
        ad, n_eval = ransac.ransac_homography_adaptive(
            t(m1), t(m2), valid, 0.05, n_iter=4096, chunk=512,
            generator=gen(100 + seed))
        assert int(n_eval) < 4096  # 55% inliers: the bound is met early
        counts_fx.append(int(fx.num_inliers))
        counts_ad.append(int(ad.num_inliers))
        gaps_ff.append(h_gap(fx.H21, fx2.H21))
        gaps_fa.append(h_gap(fx.H21, ad.H21))
    assert abs(np.mean(counts_fx) - np.mean(counts_ad)) <= 3.0
    assert np.median(gaps_fa) <= max(2.0 * np.median(gaps_ff), 0.01)
    assert np.max(gaps_fa) <= max(2.0 * np.max(gaps_ff), 0.01)


def _aligners(nets, pair, **kw):
    jr, _, resnet, _ = nets
    src, tgt, _ = pair
    j = JCoarseAligner(jr, nb_scale=1, n_iter=N_ITER, min_size=H_IMG, **kw)
    ours = CoarseAligner(resnet, "cpu", nb_scale=1, n_iter=N_ITER, min_size=H_IMG, **kw)
    j.set_pair(src, tgt)
    ours.set_pair(src, tgt)
    return j, ours


@pytest.mark.parametrize("rematch", [False, True])
def test_get_coarse_matches_jax(rng, nets, rematch):
    pair = _translated_pair(rng)
    j, ours = _aligners(nets, pair, rematch_per_call=rematch)
    assert ours.num_cached_matches == j.num_cached_matches
    mask = _border_mask()
    _, _, valid = ours._masked_matches(mask)
    cells = np.flatnonzero(valid.numpy())
    assert len(cells) > 20
    samples = rng.choice(cells, (512, 4)).astype(np.int32)
    for polish, atol in ((False, ATOL_H21), (True, 1e-6)):
        j.polish_fp64 = ours.polish_fp64 = polish
        h_ref, inl_ref = j.get_coarse(mask, injected_samples=samples)
        h, inl = ours.get_coarse(mask, injected_samples=samples)
        assert h.dtype == np.float32 and inl.shape == (H_IMG // 16, W_IMG // 16)
        np.testing.assert_allclose(h, h_ref, atol=atol)
        np.testing.assert_array_equal(inl, inl_ref)
        assert _h_error(h, pair[2]) < 0.02
    # everything excluded: no model, as in JAX
    assert ours.get_coarse(np.ones((H_IMG, W_IMG), np.float32)) == (None, None)


def test_image_helpers_match_jax(rng):
    from ransacflow_tpu.utils import image as jimage
    from ransacflow_tpu_torch.utils import image

    img = Image.fromarray((rng.rand(75, 101, 3) * 255).astype(np.uint8))
    for size in (32, 48, 64):
        assert image.min_size_shape_wh(img.size, size) == jimage.min_size_shape_wh(img.size, size)
        assert image.resized_shape_min_size(img, size) == jimage.resized_shape_min_size(img, size)
        for ours, ref in ((image.resize_min_size, jimage.resize_min_size),
                          (image.resize_max_size, jimage.resize_max_size)):
            np.testing.assert_array_equal(image.to_array(ours(img, size)),
                                          jimage.to_array(ref(img, size)))


def test_dispatch_inlier_count_is_get_coarse_inlier_sum(rng, nets):
    """The count the rotation pre-test reads back without syncing is the
    winner's inlier-mask sum under the same draws, 0 when nothing is
    found."""
    src, tgt, _ = _translated_pair(rng)
    c = CoarseAligner(nets[2], "cpu", nb_scale=1, n_iter=N_ITER, min_size=H_IMG, seed=3)
    c.set_pair(src, tgt)
    mask = _border_mask()
    c.reseed(0)
    count = c.dispatch_inlier_count(mask)
    c.reseed(0)
    _, inlier = c.get_coarse(mask)
    assert count.dtype == torch.int32 and int(count) == int(inlier.sum()) > 20
    assert int(c.dispatch_inlier_count(np.ones((H_IMG, W_IMG), np.float32))) == 0


def test_coarse_aligner_rejects_modes_the_port_lacks(nets):
    """The affine transform and the TPU's stem rewrite raise; the anchor and
    relaxed-matching modes are taken (held to JAX in test_torch_fastmodes)."""
    resnet = nets[2]
    for kw in ({"transform": "affine"}, {"stem_s2d": True}):
        with pytest.raises(ValueError):
            CoarseAligner(resnet, "cpu", **kw)


def test_reseed_depends_on_seed_and_index_alone(nets):
    a = CoarseAligner(nets[2], "cpu", seed=5)
    b = CoarseAligner(nets[2], "cpu", seed=5)
    a.reseed(3)
    b.reseed(7)
    b.reseed(3)
    torch.testing.assert_close(torch.rand(8, generator=a.generator),
                               torch.rand(8, generator=b.generator))
    b.reseed(4)
    assert not torch.equal(torch.rand(8, generator=a.generator),
                           torch.rand(8, generator=b.generator))


def test_multi_homography_predict_matches_jax(rng, nets, monkeypatch):
    """The host loop under the same draws: JAX's fixed-count RANSAC is
    wrapped to record order[raw] for its key, and the port replays them."""
    _, ja, _, align = nets
    pair = _translated_pair(rng)
    j, ours = _aligners(nets, pair)
    recorded = []
    j_ransac = jcoarse.ransac_homography

    def recording(key, m1, m2, valid, tolerance, n_iter=10000, **kw):
        n_valid = jnp.sum(valid.astype(jnp.int32))
        raw, _ = jransac._sample_minimal_sets(key, n_valid, 4, n_iter)
        samples = jnp.argsort(~valid, stable=True)[raw].astype(jnp.int32)
        recorded.append(np.asarray(samples))
        return j_ransac(key, m1, m2, valid, tolerance, n_iter=n_iter, **kw)

    t_ransac = coarse.ransac_homography

    def replaying(m1, m2, valid, tolerance, n_iter=10000, generator=None,
                  injected_samples=None):
        return t_ransac(m1, m2, valid, tolerance, n_iter=n_iter,
                        injected_samples=t(recorded.pop(0)))

    monkeypatch.setattr(jcoarse, "ransac_homography", recording)
    monkeypatch.setattr(coarse, "ransac_homography", replaying)
    kw = dict(max_coarse=2, mask_region_th=0.01, bg_mask=1.0 - _border_mask())
    ref = jmultihomo.multi_homography_predict(j, ja, **kw)
    n_fits = len(recorded)
    out = multihomo.multi_homography_predict(ours, align, **kw)
    assert n_fits > 0 and not recorded  # every fit replayed, none left over
    assert out["coarse_h"].shape[0] == ref["coarse_h"].shape[0] >= 1
    for key in ("coarse_h", "fine_flow_down8", "fine_match_down8"):
        assert out[key].shape == ref[key].shape and out[key].dtype == ref[key].dtype
        np.testing.assert_allclose(out[key], ref[key], atol=ATOL_MAPS)
    np.testing.assert_array_equal(out["bg_mask"], ref["bg_mask"])
    assert _h_error(out["coarse_h"][0], pair[2]) < 0.02


@pytest.mark.parametrize("rematch", [False, True])
def test_fused_loop_matches_host_loop(rng, nets, rematch):
    _, _, resnet, align = nets
    src, tgt, h_true = _translated_pair(rng)
    c = CoarseAligner(resnet, "cpu", nb_scale=1, n_iter=N_ITER, min_size=H_IMG,
                      polish_fp64=False, rematch_per_call=rematch)
    c.set_pair(src, tgt)
    kw = dict(max_coarse=2, mask_region_th=0.01, bg_mask=1.0 - _border_mask())
    host = multihomo.multi_homography_predict(c, align, **kw)
    fused = multihomo.multi_homography_predict_fused(c, align, **kw)
    assert host is not None and fused is not None
    assert _h_error(fused["coarse_h"][0], h_true) < 0.02
    assert _h_error(fused["coarse_h"][0], host["coarse_h"][0]) < 0.01
    assert fused["fine_flow_down8"].shape[1:] == host["fine_flow_down8"].shape[1:]
    assert np.median(np.abs(fused["fine_flow_down8"][0] - host["fine_flow_down8"][0])) < 0.02


class _HostReads(TorchDispatchMode):
    """Counts the aten ops that read a tensor's value back to the host
    (`.item()` and indexing with a 0-d tensor dispatch `_local_scalar_dense`,
    `bool()` `is_nonzero`): each one is a synchronization on the card."""

    READS = (torch.ops.aten._local_scalar_dense.default,
             torch.ops.aten.is_nonzero.default)

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func in self.READS
        return func(*args, **(kwargs or {}))


def test_fused_loop_reads_back_only_its_cond(rng, nets):
    """The device-resident loop with fixed-count RANSAC reads one flag per
    slot (the `done` test before it, and the one that ends the loop), and
    its RANSAC reads nothing back: indexing the hypotheses with the 0-d
    argmax used to read it to the host, 3 reads per fit. (Adaptive RANSAC's
    plain version reads its stop test back by design; its kernel is held to
    the same count on the card.)"""
    _, _, resnet, align = nets
    src, tgt, _ = _translated_pair(rng)
    c = CoarseAligner(resnet, "cpu", nb_scale=1, n_iter=N_ITER, min_size=H_IMG)
    c.set_pair(src, tgt)
    m1, m2, valid = c._masked_matches(_border_mask())
    with _HostReads() as reads:
        c._ransac(m1, m2, valid, torch.Generator().manual_seed(0))
    assert reads.count == 0
    with _HostReads() as reads:
        final, _ = multihomo.multi_homography_dispatch(
            c, align, max_coarse=2, mask_region_th=0.01, cycle_match=False,
            bg_mask=1.0 - _border_mask(), generator=torch.Generator().manual_seed(0))
    count, done = int(final["count"]), bool(final["done"])
    slots_run = count + done
    assert reads.count == slots_run + (done and slots_run < 3)


def _loop_inputs(j, ours, ja, align, bg):
    """The arguments of JAX's and the port's `_fused_multi_homo` for the pair
    set on both aligners."""
    jf = j_fine_features(ja, jnp.asarray(j.tgt_array)[None])
    jargs = (ja, j._bank, j._featt, j._coordsA, j._coordsB, j._cached_src,
             j._cached_valid, jnp.asarray(j.src_array)[None], jf, jnp.asarray(bg))
    tf = multihomo.fine_features(align, t(ours.tgt_array)[None])
    targs = (align, ours._bank, ours._featt, ours._coordsA, ours._coordsB,
             ours._cached_src, ours._cached_valid, t(ours.src_array)[None], tf, t(bg))
    kw = dict(feat_h=ours.feat_h, feat_w=ours.feat_w, max_coarse=2,
              cycle_match=False, kernel_size=7, n_iter=N_ITER)
    return jargs, targs, kw


def test_fused_loop_matches_jax_fused_loop(rng, nets):
    _, ja, _, align = nets
    pair = _translated_pair(rng)
    j, ours = _aligners(nets, pair, polish_fp64=False)
    bg = 1.0 - _border_mask()
    jargs, targs, kw = _loop_inputs(j, ours, ja, align, bg)
    ref = jmultihomo._fused_multi_homo(*jargs, jax.random.PRNGKey(3), 0.05, 0.01,
                                       n_points=4, transform="homography",
                                       rematch=False, **kw)
    out = multihomo._fused_multi_homo(*targs, torch.Generator().manual_seed(3),
                                      0.05, 0.01, rematch=False, **kw)
    assert int(out["count"]) == int(ref["count"]) >= 1
    assert bool(out["done"]) == bool(ref["done"])
    assert _h_error(out["hs"][0].numpy(), np.asarray(ref["hs"][0])) < 0.01
    assert out["hs"].shape == ref["hs"].shape and out["flows"].shape == ref["flows"].shape
    n = int(out["count"])
    assert (out["n_evaluated"][:n] == N_ITER).all()


def test_fused_loop_batch_is_a_loop_over_pairs(rng, nets):
    _, ja, _, align = nets
    bg = 1.0 - _border_mask()
    per_pair = []
    for dx, dy in ((32, 16), (-24, 8)):
        j, ours = _aligners(nets, _translated_pair(rng, dx, dy), polish_fp64=False)
        _, targs, kw = _loop_inputs(j, ours, ja, align, bg)
        per_pair.append(targs)
    coords_a, coords_b = per_pair[0][3], per_pair[0][4]
    banks, featts, srcs_i, valids, mids, ffines, bgs = (
        torch.stack([p[i] for p in per_pair]) for i in (1, 2, 5, 6, 7, 8, 9))
    gens = [torch.Generator().manual_seed(s) for s in (11, 12)]
    batched = multihomo._fused_multi_homo_batch(
        align, banks, featts, coords_a, coords_b, srcs_i, valids, mids, ffines,
        bgs, gens, 0.05, 0.01, rematch=False, **kw)
    assert "mask" not in batched
    for k, s in enumerate((11, 12)):
        single = multihomo._fused_multi_homo(*per_pair[k],
                                             torch.Generator().manual_seed(s),
                                             0.05, 0.01, rematch=False, **kw)
        for key, v in batched.items():
            assert torch.equal(v[k], single[key]), key


def test_fused_loop_adaptive_matches_fixed_geometry(rng, nets):
    """adaptive_chunk changes the hypothesis budget only: the same count and
    first homography as fixed-count (tests/test_matching_ransac.py:345),
    after one block of 4096 on this well-matched pair."""
    _, _, resnet, align = nets
    src, tgt, h_true = _translated_pair(rng)
    kw = dict(max_coarse=2, mask_region_th=0.01, bg_mask=1.0 - _border_mask())
    outs = {}
    for chunk in (0, 4096):
        c = CoarseAligner(resnet, "cpu", nb_scale=1, n_iter=8192, min_size=H_IMG,
                          polish_fp64=False, adaptive_chunk=chunk, seed=chunk)
        c.set_pair(src, tgt)
        final, _ = multihomo.multi_homography_dispatch(c, align, **kw)
        outs[chunk] = final
    fixed, adaptive = outs[0], outs[4096]
    assert int(adaptive["count"]) == int(fixed["count"])
    assert int(adaptive["n_evaluated"][0]) == 4096
    assert (fixed["n_evaluated"][:int(fixed["count"])] == 8192).all()
    assert _h_error(adaptive["hs"][0].numpy(), fixed["hs"][0].numpy()) < 0.02
    assert _h_error(adaptive["hs"][0].numpy(), h_true) < 0.02


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("adaptive_chunk", [0, 1024])
def test_fused_loop_reads_back_once_per_slot(cuda, rng, adaptive_chunk):
    """On the card, the device-resident loop's only synchronizing calls are
    its `done` tests, one before each slot and one that ends the loop."""
    import warnings

    from ransacflow_tpu_torch.models.convert import init_alignment_params, init_resnet50_layer3

    src, tgt, _ = _translated_pair(rng)
    resnet = init_resnet50_layer3(torch.Generator().manual_seed(0), cuda)
    align = init_alignment_params(torch.Generator().manual_seed(1), cuda)
    c = CoarseAligner(resnet, cuda, nb_scale=1, n_iter=N_ITER, min_size=H_IMG,
                      adaptive_chunk=adaptive_chunk)
    c.set_pair(src, tgt)
    bg = torch.from_numpy(1.0 - _border_mask()).to(cuda)
    ffine = multihomo.fine_features(align, c.put(c.tgt_array)[None])
    args = (align, c._bank, c._featt, c._coordsA, c._coordsB, c._cached_src,
            c._cached_valid, c.put(c.src_array)[None], ffine, bg)
    kw = dict(feat_h=c.feat_h, feat_w=c.feat_w, max_coarse=2, cycle_match=False,
              kernel_size=7, n_iter=N_ITER, rematch=False, adaptive_chunk=adaptive_chunk)
    multihomo._fused_multi_homo(*args, torch.Generator(device=cuda).manual_seed(0),
                                0.05, 0.01, **kw)  # warm-up: builds the kernels
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = multihomo._fused_multi_homo(
                *args, torch.Generator(device=cuda).manual_seed(0), 0.05, 0.01, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("called a synchronizing" in str(w.message) for w in caught)
    count, done = int(out["count"]), bool(out["done"])
    slots_run = count + done
    assert 1 <= count <= 3
    assert syncs == slots_run + (done and slots_run < 3)
