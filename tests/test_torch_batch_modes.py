"""Parity of the port's batch modes of `fused_align_batch` ('scan', 'vmap',
'hybrid', 'chunk2', 'chunkf2', 'chunkv2') with the JAX package, on the CPU.

K = 4 pairs of tests/test_fused.py's shape (64x64 targets, two scales),
256 hypotheses. Each mode is fed JAX's per-pair RANSAC draws (pair k's
`_sample_minimal_sets` under keys[k], mapped through the stable valid-first
order) and held to JAX's `fused_align_batch` in the same mode; once more
with adaptive RANSAC and once in the anchor + relaxed mode on a three-scale
pyramid. Each mode is also held to the port's own 'scan' under one shared
generator (the draws' contract: one seed a pair, in pair order); every
mode runs one fit and one fine call a chunk; and the wrappers of kernels 2,
3, 4 and 12, given CPU tensors with a pair axis, to their calls on each pair.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ransacflow_tpu.models import init_resnet50_layer3 as j_init_resnet
from ransacflow_tpu.ops import ransac as jransac
from ransacflow_tpu.pipeline import fused as jfused
from ransacflow_tpu.pipeline import init_alignment_params as j_init_align
from ransacflow_tpu_torch import kernels
from ransacflow_tpu_torch.kernels import anchor_resample, matching, ransac, ransac_adaptive
from ransacflow_tpu_torch.models import convert
from ransacflow_tpu_torch.pipeline import fused

K = 4
N_ITER = 256
MODES = ("scan", "vmap", "hybrid", "chunk2", "chunkf2", "chunkv2")
ATOL_H21 = 1e-4   # fp32 4-point solves in two libraries
ATOL_MAPS = 1e-4  # fp32 conv stacks in two libraries (~20 convolutions)
MAPS = ("flow", "match", "flow_down8", "match_down8")
# The matchability is zero outside the source, a step at |flow| = 1. These
# random pairs align by the identity (up to 1e-7), whose grid lands exactly
# on that border, so a last-bit difference of H21 flips a border pixel:
# `match` is compared off the pixels whose reference flow lies within this
# of +-1.
BORDER = 1e-5


def _off_border(flow):
    """(K, H, W) bool: pixels of the (K, 1, H, W, 2) grid off the border."""
    return ~(np.abs(np.abs(np.asarray(flow)[:, 0]) - 1) < BORDER).any(axis=-1)


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


def close(ours, ref, atol):
    np.testing.assert_allclose(ours.detach().float().numpy(), np.asarray(ref), atol=atol)


def _batch(sizes=(64, 32), seed=0):
    """tests/test_fused.py's batch: K pairs, a pyramid of `sizes` square
    scales and a 64x64 target each, and K keys."""
    rng = np.random.RandomState(seed)
    pyramids = tuple(rng.rand(K, 1, s, s, 3).astype(np.float32) for s in sizes)
    targets = rng.rand(K, 1, 64, 64, 3).astype(np.float32)
    return pyramids, targets, jax.random.split(jax.random.PRNGKey(2), K)


def _jax_draws(jr, pyramids, targets, keys, adaptive_chunk=0, **mode):
    """(K, rows, 4) match indices: pair k's JAX draws under keys[k] (block i
    of an adaptive fit under fold_in(keys[k], i))."""
    out = []
    for k in range(K):
        _, _, valid = jfused._coarse_match(jr, tuple(jnp.asarray(p[k]) for p in pyramids),
                                           jnp.asarray(targets[k]), **mode)
        n_valid = jnp.sum(valid.astype(jnp.int32))
        order = np.argsort(~np.asarray(valid), kind="stable")
        if adaptive_chunk:
            raw = np.concatenate([
                np.asarray(jransac._sample_minimal_sets(jax.random.fold_in(keys[k], i),
                                                        n_valid, 4, adaptive_chunk)[0])
                for i in range(-(-N_ITER // adaptive_chunk))])
        else:
            raw = np.asarray(jransac._sample_minimal_sets(keys[k], n_valid, 4, N_ITER)[0])
        out.append(order[raw])
    return np.stack(out).astype(np.int32)


def _against_jax(nets, batch_mode, sizes=(64, 32), **mode):
    jr, ja, resnet, align = nets
    pyramids, targets, keys = _batch(sizes)
    draws = _jax_draws(jr, pyramids, targets, keys, **mode)
    ref = jfused.fused_align_batch(jr, ja, tuple(map(jnp.asarray, pyramids)),
                                   jnp.asarray(targets), keys, n_iter=N_ITER,
                                   batch_mode=batch_mode, **mode)
    kernels.reset_launch_counts()
    ours = fused.fused_align_batch(resnet, align, tuple(map(t, pyramids)), t(targets),
                                   n_iter=N_ITER, injected_samples=t(draws),
                                   batch_mode=batch_mode, **mode)
    assert set(kernels.launch_counts().values()) == {0}  # CPU: the plain versions
    np.testing.assert_array_equal(ours["found"].numpy(), np.asarray(ref["found"]))
    assert ours["found"].all()
    np.testing.assert_array_equal(ours["num_inliers"].numpy(), np.asarray(ref["num_inliers"]))
    close(ours["H21"], ref["H21"], atol=ATOL_H21)
    off = _off_border(ref["flow"])
    assert off.mean() > 0.9
    for key in MAPS:
        assert ours[key].shape == ref[key].shape, key
        if key == "match":
            close(ours[key][t(off)], np.asarray(ref[key])[off], atol=ATOL_MAPS)
        else:
            close(ours[key], ref[key], atol=ATOL_MAPS)


@pytest.mark.parametrize("batch_mode", MODES)
def test_batch_mode_matches_jax(nets, batch_mode):
    _against_jax(nets, batch_mode)


def test_batch_mode_adaptive_matches_jax(nets):
    """'vmap' with adaptive RANSAC in blocks of 128 (kernel 4's batch
    form's plain twin over all 4 pairs), under JAX's per-block draws."""
    _against_jax(nets, "vmap", adaptive_chunk=128)


def test_batch_mode_anchor_relaxed_matches_jax(nets):
    """'chunkv2' in the anchor mode at stride 2 (kernel 12's batch form's
    plain twin) with relaxed reciprocity, on a three-scale pyramid."""
    _against_jax(nets, "chunkv2", sizes=(64, 48, 32), anchor_stride=2, relax_cells=1)


@pytest.mark.parametrize("batch_mode", MODES[1:])
def test_batch_mode_matches_scan_under_one_generator(nets, batch_mode):
    """Every mode draws pair k's seed where 'scan' does: one seed a pair,
    in pair order, from the one shared generator, which ends in the same
    state. The matches and the fits are those of 'scan'."""
    _, _, resnet, align = nets
    pyramids, targets, _ = _batch(seed=1)
    runs = {}
    for mode in ("scan", batch_mode):
        gen = torch.Generator().manual_seed(5)
        runs[mode] = fused.fused_align_batch(resnet, align, tuple(map(t, pyramids)),
                                             t(targets), gen, n_iter=N_ITER,
                                             batch_mode=mode)
        runs[mode, "state"] = gen.get_state()
    scan, ours = runs["scan"], runs[batch_mode]
    assert torch.equal(runs["scan", "state"], runs[batch_mode, "state"])
    for key in ("found", "num_inliers", "H21"):
        assert torch.equal(ours[key], scan[key]), key
    off = t(_off_border(scan["flow"]))
    for key in MAPS:
        assert ours[key].shape == scan[key].shape
        torch.testing.assert_close(ours[key][off] if key == "match" else ours[key],
                                   scan[key][off] if key == "match" else scan[key],
                                   atol=1e-5, rtol=0)


def _ransac_problems(rng, n=96):
    """K match sets of n (x, y) cells, each a shifted copy but for its
    outliers (50%, 100%, 20% and 70% of the pairs' matches), some invalid,
    and K seeds."""
    m2 = np.concatenate([rng.uniform(-1, 1, (K, n, 2)), np.ones((K, n, 1))], axis=2)
    m1 = m2.copy()
    m1[:, :, :2] += 0.1 * rng.randn(K, 1, 2)
    outlier = rng.rand(K, n) < np.array([0.5, 1.0, 0.2, 0.7])[:, None]
    m1[outlier, :2] = rng.uniform(-1, 1, (int(outlier.sum()), 2))
    valid = rng.rand(K, n) > 0.1
    seeds = torch.randint(0, 2 ** 62, (K,), generator=torch.Generator().manual_seed(4))
    return t(m1.astype(np.float32)), t(m2.astype(np.float32)), t(valid), seeds


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kernel", ["mutual_argmax", "anchor_resample", "ransac_fit",
                                    "ransac_adaptive"])
def test_batched_call_is_a_loop_of_single_calls(rng, kernel):
    """Each wrapper on CPU tensors with a leading pair axis gives, pair by
    pair, its call on that pair alone (no pair axis for K2, K3 and K4; k = 1
    for K12, whose maps always carry the axis), bit for bit, takes bf16 at
    its boundary as that call does, and raises under grad; the adaptive fit
    stops each pair after its own blocks and leaves -1 in the rows of its
    record past the stop."""
    if kernel == "mutual_argmax":
        score = t(rng.randn(K, 40, 24).astype(np.float32))
        score[1, 3, :] = score[1, 7, :]  # tied rows: the lowest index wins
        valid_b = t(rng.rand(K, 24) > 0.2)
        for s, relax, grid_w, mask in ((score, 0, None, None), (score, 1, 6, valid_b),
                                       (score.bfloat16(), 0, None, valid_b)):
            batch = matching.mutual_argmax(s, relax, grid_w, mask)
            assert batch[3].dtype == s.dtype
            for p in range(K):
                _equal([b[p] for b in batch], matching.mutual_argmax(
                    s[p], relax, grid_w, None if mask is None else mask[p]))
        call = lambda x: matching.mutual_argmax(x)  # noqa: E731
        needs_grad = score.requires_grad_()
    elif kernel == "anchor_resample":
        shapes, nearest = [(64, 64), (48, 48), (32, 32)], [0, 0, 2]
        maps = {0: t(rng.randn(K, 4, 4, 8).astype(np.float32)),
                2: t(rng.randn(K, 2, 2, 8).astype(np.float32))}
        for m in (maps, {i: x.bfloat16() for i, x in maps.items()}):
            batch = anchor_resample.anchor_resample_bank(m, shapes, nearest)
            assert batch.dtype == m[0].dtype and batch.shape[0] == K
            for p in range(K):
                assert torch.equal(batch[p:p + 1], anchor_resample.anchor_resample_bank(
                    {i: x[p:p + 1] for i, x in m.items()}, shapes, nearest))
        call = lambda x: anchor_resample.anchor_resample_bank(  # noqa: E731
            {0: x, 2: maps[2]}, shapes, nearest)
        needs_grad = maps[0].requires_grad_()
    else:
        m1, m2, valid, seeds = _ransac_problems(rng)
        if kernel == "ransac_fit":
            args, fn = (0.05, 200), ransac.ransac_fit
        else:
            args, fn = (0.05, 1000, 64, 0.99), ransac_adaptive.ransac_adaptive
        batch = fn(m1, m2, valid, *args, seed=seeds, record=True)
        singles = [fn(m1[p], m2[p], valid[p], *args, seed=seeds[p:p + 1], record=True)
                   for p in range(K)]
        for p, one in enumerate(singles):
            _equal(ransac.pair_of(batch[0], p), one[0])
            n = one[-1].counts.shape[0] if kernel == "ransac_fit" else int(one[1])
            _equal([x[:n] for x in ransac.pair_of(batch[-1], p)], [x[:n] for x in one[-1]])
        if kernel == "ransac_adaptive":
            n_eval = batch[1]
            assert n_eval.shape == (K,) and singles[0][1].shape == ()
            assert len(set(n_eval.tolist())) > 1  # the pairs stop after different blocks
            for p, one in enumerate(singles):
                assert int(n_eval[p]) == int(one[1])
                assert (batch[2].counts[p, int(one[1]):] == -1).all()  # no rows past the stop
        call = lambda x: fn(x, m2, valid, *args, seed=seeds)  # noqa: E731
        needs_grad = m1.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        call(needs_grad)


@pytest.mark.parametrize("batch_mode", MODES + ("fused_align",))
def test_every_mode_runs_one_fit_and_one_fine_call_a_chunk(nets, monkeypatch, batch_mode):
    """Every batch mode runs each chunk through `fused._ransac_batch` and
    `fused._fine_with_gate_batch` once, looked up by name at call time (the
    names a caller patches to stand in for a stage), and `fused_align` is
    one chunk of one pair."""
    _, _, resnet, align = nets
    pyramids, targets, _ = _batch()
    calls = {"fit": [], "fine": []}
    fit, fine = fused._ransac_batch, fused._fine_with_gate_batch

    def counted_fit(m1, *args):
        calls["fit"].append(m1.shape[0])
        return fit(m1, *args)

    def counted_fine(align_nets, pyramid, target, *args):
        calls["fine"].append(target.shape[0])
        return fine(align_nets, pyramid, target, *args)

    monkeypatch.setattr(fused, "_ransac_batch", counted_fit)
    monkeypatch.setattr(fused, "_fine_with_gate_batch", counted_fine)
    gen = torch.Generator().manual_seed(0)
    if batch_mode == "fused_align":
        out = fused.fused_align(resnet, align, tuple(t(p[0]) for p in pyramids), t(targets[0]),
                                gen, n_iter=8)
        assert out["H21"].shape == (3, 3) and out["flow"].shape == (1, 64, 64, 2)
        chunks = [1]
    else:
        fused.fused_align_batch(resnet, align, tuple(map(t, pyramids)), t(targets), gen,
                                n_iter=8, batch_mode=batch_mode)
        chunk = fused.parse_batch_mode(batch_mode, K)
        chunks = [chunk] * (K // chunk)
    assert calls == {"fit": chunks, "fine": chunks}


@pytest.mark.parametrize("batch_mode,match", [("chunk3", "divisible by the chunk size"),
                                              ("chunkz2", "unknown batch_mode"),
                                              ("stream", "unknown batch_mode")])
def test_batch_mode_errors(nets, batch_mode, match):
    """The reference's two errors: K not divisible by the chunk size, and an
    unknown mode."""
    _, _, resnet, align = nets
    pyramids, targets, _ = _batch()
    with pytest.raises(ValueError, match=match):
        fused.fused_align_batch(resnet, align, tuple(map(t, pyramids)), t(targets),
                                torch.Generator().manual_seed(0), n_iter=8,
                                batch_mode=batch_mode)


def test_batch_modes_raise_where_jax_does(nets):
    """JAX's `fused_align_batch` raises ValueError on the same inputs."""
    jr, ja, _, _ = nets
    pyramids, targets, keys = _batch()
    for batch_mode in ("chunk3", "stream"):
        with pytest.raises(ValueError):
            jfused.fused_align_batch(jr, ja, tuple(map(jnp.asarray, pyramids)),
                                     jnp.asarray(targets), keys, n_iter=8,
                                     batch_mode=batch_mode)


def test_mutual_argmax_schedule_of_k_pairs_is_one_wave():
    """The schedule of k scores splits about one wave of blocks among the
    pairs, each pair's chunks covering its rows."""
    for n_pairs in (1, 2, 4, 32):
        n_chunks, rows, n_slices, _ = matching.schedule(13065, 1200, True, 132, n_pairs)
        assert n_chunks * rows >= 13065 > (n_chunks - 1) * rows
        assert n_pairs * n_chunks * n_slices <= matching.BLOCKS_PER_SM * 132 or n_chunks == 1
    assert matching.schedule(13065, 1200, True, 132) == matching.schedule(13065, 1200, True,
                                                                          132, 1)
