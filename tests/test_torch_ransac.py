"""RANSAC's draws, its plain fits against the JAX package, and, on the card,
kernels 3 and 4 against their plain versions.

The draws are Philox4x32-10 of the hypothesis index under a seed, so the
plain version must reproduce Random123's known answers and the draw rule bit
for bit; JAX's threefry cannot be matched, so the parity tests with JAX
inject the sets.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ransacflow_tpu.ops import ransac as jransac
from ransacflow_tpu_torch import kernels
from ransacflow_tpu_torch.kernels.ransac import (
    boundary_flips,
    draw_sets_ref,
    philox4x32,
    ransac_fit,
    ransac_fit_ref,
    ransac_score_ref,
)
from ransacflow_tpu_torch.kernels.ransac_adaptive import ransac_adaptive, ransac_adaptive_ref
from ransacflow_tpu_torch.ops import ransac
from ransacflow_tpu_torch.ops.homography import reprojection_error

TOL = 0.05


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
    return torch.from_numpy(np.asarray(a))


def _seed(value):
    return torch.tensor([value], dtype=torch.int64)


def _matches(rng, n=96, inlier_frac=0.6, valid_frac=0.85):
    """match1, match2 (n, 3) float32 of a known homography with outliers and
    invalid rows (tests/test_torch_ops.py's problem)."""
    m2 = np.concatenate([rng.uniform(-1, 1, (n, 2)), np.ones((n, 1))], 1)
    h = np.array([[1.05, 0.02, 0.03], [-0.01, 0.97, -0.02], [0.02, -0.03, 1.0]])
    p = m2 @ h.T
    m1 = p[:, :2] / p[:, 2:] + 0.004 * rng.randn(n, 2)
    out = rng.rand(n) > inlier_frac
    m1[out] = rng.uniform(-1, 1, (out.sum(), 2))
    m1 = np.concatenate([m1, np.ones((n, 1))], 1)
    valid = rng.rand(n) < valid_frac
    return m1.astype(np.float32), m2.astype(np.float32), valid


# Random123's known-answer vectors for Philox4x32-10: counter, key, output
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT, ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    got = philox4x32(tuple(torch.tensor([c]) for c in counter),
                     tuple(torch.tensor([k]) for k in key))
    assert tuple(int(w) for w in got) == want


def _numpy_draws(valid, seed, n_rows, first=0):
    """The draw rule written again in numpy: Philox4x32-10 in uint64, the
    rank in float32, the stable valid-first order."""
    mask = np.uint64(0xFFFFFFFF)
    c0 = np.arange(first, first + n_rows, dtype=np.uint64)
    c1 = c2 = c3 = np.zeros_like(c0)
    k0, k1 = np.uint64(seed & 0xFFFFFFFF), np.uint64(seed >> 32)
    for r in range(10):
        if r:
            k0, k1 = (k0 + np.uint64(0x9E3779B9)) & mask, (k1 + np.uint64(0xBB67AE85)) & mask
        p0 = np.uint64(0xD2511F53) * c0  # < 2**64: exact in uint64
        p1 = np.uint64(0xCD9E8D57) * c2
        c0, c1, c2, c3 = (p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & mask, \
            (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & mask
    words = np.stack([c0, c1, c2, c3], 1)
    n_valid = np.float32(max(int(valid.sum()), 1))
    u = (words >> np.uint64(8)).astype(np.float32) * np.float32(2.0 ** -24)
    rank = np.minimum(np.floor(u * n_valid).astype(np.int64), int(n_valid) - 1)
    return np.argsort(~valid, kind="stable")[rank].astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 62 - 1, 0x2B992DDFA23249D6])
def test_draws_follow_the_rule(rng, seed):
    """The plain draws against the rule in numpy, key words of every size,
    hypotheses past 2**31 / 4 included."""
    valid = rng.rand(300) > 0.4
    for first in (0, 5000):
        ours = draw_sets_ref(t(valid), _seed(seed), 700, first=first)
        np.testing.assert_array_equal(ours.numpy(), _numpy_draws(valid, seed, 700, first))


def test_draws_valid_uniform_and_duplicates_rejected():
    """The bounds of test_torch_ops' sampler test, for the Philox draws."""
    valid = torch.from_numpy(np.random.RandomState(1).rand(200) > 0.7)
    s = draw_sets_ref(valid, _seed(3), 20000)
    assert s.dtype == torch.int32 and s.shape == (20000, 4)
    assert valid[s.long()].all()
    hist = torch.bincount(s.flatten().long(), minlength=200)[valid].float()
    assert hist.min() > 0.6 * hist.mean() and hist.max() < 1.4 * hist.mean()
    few = torch.zeros(200, dtype=torch.bool)
    few[[3, 50, 77, 120, 199]] = True
    s = draw_sets_ref(few, _seed(4), 500)
    assert few[s.long()].all()
    dup = torch.tensor([len(set(r)) < 4 for r in s.tolist()])
    assert dup.any() and (~dup).any()


def test_same_seed_same_sets_and_adaptive_rows_are_a_prefix(rng):
    """Sets depend on the seed and the hypothesis index alone: the adaptive
    fit's rows are the fixed fit's first rows, wherever its loop stops."""
    m1, m2, valid = (t(a) for a in _matches(rng, n=120, inlier_frac=0.0))
    seed = _seed(987654321)
    s = draw_sets_ref(valid, seed, 600)
    assert torch.equal(s, draw_sets_ref(valid, seed, 600))
    assert torch.equal(s[256:], draw_sets_ref(valid, seed, 344, first=256))
    assert not torch.equal(s, draw_sets_ref(valid, _seed(987654322), 600))
    _, fixed = ransac_fit_ref(m1, m2, valid, 0.003, 600, seed=seed)
    _, n_eval, adaptive = ransac_adaptive_ref(m1, m2, valid, 0.003, 600, 128, 0.999, seed=seed)
    assert int(n_eval) == 640  # structureless: every block
    assert torch.equal(adaptive.sets[:600], fixed.sets)
    assert torch.equal(adaptive.counts[:600], fixed.counts)


def test_ops_draw_one_seed_from_the_generator(rng):
    """Each op draws one seed: `sample_minimal_sets` gives the op's sets,
    and the generator moves on by the same amount for both ops."""
    m1, m2, valid = (t(a) for a in _matches(rng, n=80))
    gens = [torch.Generator().manual_seed(11) for _ in range(4)]
    sets = ransac.sample_minimal_sets(valid, 256, gens[0])
    fit = ransac.ransac_homography(m1, m2, valid, TOL, n_iter=256, generator=gens[1])
    _, record = ransac_fit_ref(m1, m2, valid, TOL, 256, seed=ransac.draw_seed(gens[2], "cpu"))
    assert torch.equal(record.sets, sets)
    assert torch.equal(fit.best_sample, sets[torch.argmax(record.counts)])
    ransac.ransac_homography_adaptive(m1, m2, valid, TOL, n_iter=256, chunk=64,
                                      generator=gens[3])
    nxt = [torch.randint(0, 2 ** 62, (1,), generator=g) for g in gens]
    assert all(torch.equal(n, nxt[0]) for n in nxt)


@pytest.mark.parametrize("n_valid", [0, 3, 4, 30])
def test_fit_ref_matches_jax_at_the_edges(rng, n_valid):
    """The plain fit against JAX's `ransac_homography` under the same
    injected sets (the Philox draws), on 37 matches with 0, 3, 4 and 30
    valid: found, count, set and mask equal, H to 1e-4 when found."""
    m1, m2, _ = _matches(rng, n=37)
    valid = np.zeros(37, bool)
    valid[rng.permutation(37)[:n_valid]] = True
    samples = draw_sets_ref(t(valid), _seed(n_valid), 300)
    ref = jransac.ransac_homography(
        jax.random.PRNGKey(0), jnp.asarray(m1), jnp.asarray(m2), jnp.asarray(valid), TOL,
        n_iter=300, injected_samples=jnp.asarray(samples.numpy()))
    ours, _ = ransac_fit_ref(t(m1), t(m2), t(valid), TOL, 300, samples=samples)
    assert bool(ours.found) == bool(ref.found) == (n_valid >= 4)
    assert int(ours.num_inliers) == int(ref.num_inliers)
    np.testing.assert_array_equal(ours.best_sample.numpy(), np.asarray(ref.best_sample))
    np.testing.assert_array_equal(ours.inlier_mask.numpy(), np.asarray(ref.inlier_mask))
    if n_valid >= 4:
        np.testing.assert_allclose(ours.H21.numpy(), np.asarray(ref.H21), atol=1e-4)
    if n_valid == 0:
        assert (samples == 0).all()


def test_adaptive_ref_keeps_the_identity_without_a_model(rng):
    """No set is ever scored above 0 (3 valid matches): the adaptive fit
    keeps the identity and the zero set, runs every block, finds nothing."""
    m1, m2, _ = _matches(rng, n=40)
    valid = np.zeros(40, bool)
    valid[[2, 9, 31]] = True
    res, n_eval, _ = ransac_adaptive_ref(t(m1), t(m2), t(valid), TOL, 300, 128, 0.999,
                                         seed=_seed(5))
    assert int(n_eval) == 384 and not bool(res.found) and int(res.num_inliers) == 0
    assert torch.equal(res.H21, torch.eye(3)) and not res.inlier_mask.any()
    assert (res.best_sample == 0).all()


def test_boundary_flips_explain_only_matches_at_the_tolerance(rng):
    """A count one off is explained when a valid match lies within 1e-5 of
    the tolerance under the plain H, and not otherwise or when it is off by
    more matches than lie there."""
    m1, m2, valid = (t(a) for a in _matches(rng, n=200, valid_frac=1.0))
    sets = draw_sets_ref(valid, _seed(8), 6)
    H, _ = ransac_score_ref(m1, m2, valid, sets, TOL)
    k = next(i for i in range(200) if i not in sets[0].tolist())
    p = H[0] @ m2[k]
    m1[k, :2] = p[:2] / p[2] + torch.tensor([TOL - 2e-6, 0.0])
    _, counts_ref = ransac_score_ref(m1, m2, valid, sets, TOL)
    got = counts_ref.clone()
    got[0] += 1
    got[1] += 1
    got[2] -= 2
    differ, explained = boundary_flips(m1, m2, valid, sets, got, counts_ref, TOL)
    assert differ.tolist() == [True, True, True, False, False, False]
    assert explained.tolist() == [True, False, False, False, False, False]


# -- on the card: the kernels against their plain versions ------------------


def _assert_fit_matches(fit, rec, ref, rec_ref, m1, m2, valid, record_property):
    """Identical sets and winner; per-hypothesis counts that agree on >=
    99.9%, a differing count agreeing only when a flip at the tolerance
    boundary explains it (`boundary_flips`); H21 to 1e-4; the mask equal off
    matches within 1e-6 of the tolerance. The counts that differ and those
    explained go to the test's properties (a JUnit XML report shows them)."""
    n_rows = rec_ref.counts.shape[0]
    assert torch.equal(rec.sets[:n_rows], rec_ref.sets)
    differ, explained = boundary_flips(m1, m2, valid, rec_ref.sets, rec.counts[:n_rows],
                                       rec_ref.counts, TOL)
    agree = 1 - (differ & ~explained).float().mean().item()
    record_property("counts_differ", int(differ.sum()))
    record_property("counts_explained", int(explained.sum()))
    assert agree >= 0.999, (agree, int(differ.sum()), int(explained.sum()))
    assert int(fit.num_inliers) == int(ref.num_inliers)
    assert bool(fit.found) == bool(ref.found)
    assert torch.equal(fit.best_sample, ref.best_sample)
    torch.testing.assert_close(fit.H21, ref.H21, atol=1e-4, rtol=0)
    err = reprojection_error(m1, m2, ref.H21[None])[0]
    off = (err - TOL).abs() > 1e-6
    assert torch.equal(fit.inlier_mask[off], ref.inlier_mask[off])


FIT_CASES = [(1200, 10000), (5000, 10000), (1200, 50000), (1200, 777), (5000, 777)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,n_iter", FIT_CASES)
def test_fit_kernel_matches_plain(cuda, rng, n, n_iter, record_property):
    """Kernel 3 against its plain version on the same seed: 1200 and 5000
    matches (3 tiles), 10k, 50k and 777 hypotheses (not a multiple of a
    block's), one launch each."""
    m1, m2, valid = (t(a).to(cuda) for a in _matches(rng, n=n))
    seed = _seed(2024 + n_iter).to(cuda)
    kernels.reset_launch_counts()
    fit, rec = ransac_fit(m1, m2, valid, TOL, n_iter, seed=seed, record=True)
    assert kernels.launch_counts()["ransac_score"] == 1
    ref, rec_ref = ransac_fit_ref(m1, m2, valid, TOL, n_iter, seed=seed)
    _assert_fit_matches(fit, rec, ref, rec_ref, m1, m2, valid, record_property)


@pytest.mark.gpu
def test_fit_kernel_injected_duplicates(cuda, rng, record_property):
    m1, m2, valid = (t(a).to(cuda) for a in _matches(rng, n=1500))
    s = t(rng.randint(0, 1500, (3000, 4)).astype(np.int32))
    s[:9, 1] = s[:9, 0]
    s = s.to(cuda)
    fit, rec = ransac_fit(m1, m2, valid, TOL, 3000, samples=s, record=True)
    ref, rec_ref = ransac_fit_ref(m1, m2, valid, TOL, 3000, samples=s)
    assert (rec.counts[:9] == 0).all()
    _assert_fit_matches(fit, rec, ref, rec_ref, m1, m2, valid, record_property)


@pytest.mark.gpu
@pytest.mark.parametrize("case,frac,blocks", [("one_block", 0.6, 1),
                                              ("all_blocks", 0.0, 13)])
def test_adaptive_kernel_matches_plain(cuda, rng, case, frac, blocks, record_property):
    """Kernel 4 against its plain version on the same seed, under sync-debug
    'error': equal blocks run, sets, winner and mask (1200 matches, blocks
    of 4096, cap 50k)."""
    m1, m2, valid = (t(a).to(cuda) for a in _matches(rng, n=1200, inlier_frac=frac))
    seed = _seed(77).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fit, n_eval, rec = ransac_adaptive(m1, m2, valid, TOL, 50000, 4096, 0.999, seed=seed,
                                           record=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref, n_eval_ref, rec_ref = ransac_adaptive_ref(m1, m2, valid, TOL, 50000, 4096, 0.999,
                                                   seed=seed)
    assert int(n_eval) == int(n_eval_ref) == blocks * 4096
    _assert_fit_matches(fit, rec, ref, rec_ref, m1, m2, valid, record_property)


@pytest.mark.gpu
def test_one_launch_per_fit(cuda, rng):
    """Each op's fit is the seed draw and one kernel: one launch on the
    counter, two device kernels in a profiler trace, nothing read back. Both
    ops go in one trace: in one pytest process on the card a second trace
    once came back empty."""
    from torch.profiler import ProfilerActivity, profile

    m1, m2, valid = (t(a).to(cuda) for a in _matches(rng, n=1200))
    gen = torch.Generator(device=cuda).manual_seed(0)
    fits = {"ransac_score": lambda: ransac.ransac_homography(m1, m2, valid, TOL, 10000,
                                                             generator=gen),
            "ransac_adaptive": lambda: ransac.ransac_homography_adaptive(
                m1, m2, valid, TOL, 50000, 4096, generator=gen)}
    for fit in fits.values():
        fit()
    torch.cuda.synchronize()
    counts = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for name, fit in fits.items():
            kernels.reset_launch_counts()
            torch.cuda.set_sync_debug_mode("error")
            try:
                fit()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            counts[name] = kernels.launch_counts()
        torch.cuda.synchronize()
    for name, c in counts.items():
        assert c[name] == 1 and sum(c.values()) == 1, (name, c)
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 4 and ["ransac" in n for n in names] == [False, True] * 2, names
