"""Parity of the port's sharded serving paths (`ransacflow_tpu_torch/
parallel/mesh.py`: `sharded_align_pairs`, `sharded_ransac`) with the JAX
package's, on the CPU: the port's "devices" are CPU slots (a thread each),
the JAX side runs on the conftest's 8-device CPU mesh. (The data-parallel
training step is tests/test_torch_parallel.py's.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransacflow_tpu.pipeline import init_alignment_params as j_init_align

WORLD = 2  # devices of the mesh


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


SERVE_HW, SERVE_ITER = 64, 256


@pytest.fixture(scope="module")
def serving():
    """JAX-initialized networks in both packages and 2 same-shape pairs
    (one 64x64 scale, as JAX's tests/test_parallel.py)."""
    from ransacflow_tpu.models import init_resnet50_layer3 as j_init_resnet
    from ransacflow_tpu_torch.models import convert

    jr, ja = j_init_resnet(jax.random.PRNGKey(0)), j_init_align(jax.random.PRNGKey(1))
    rng = np.random.RandomState(5)
    pyramids = (rng.rand(WORLD, 1, SERVE_HW, SERVE_HW, 3).astype(np.float32),)
    targets = rng.rand(WORLD, 1, SERVE_HW, SERVE_HW, 3).astype(np.float32)
    return (jr, ja, convert.resnet50_layer3_from_tree(jr, "cpu"),
            convert.alignment_params_from_tree(ja, "cpu"), pyramids, targets)


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_sharded_align_pairs_is_fused_align_batch(serving):
    """Over ['cpu', 'cpu']: bit for bit `fused_align_batch` over the same
    pairs with one generator a pair seeded by the per-pair seeds drawn up
    front, and bit for bit itself over ['cpu'] (a pair's outputs do not
    depend on the device count)."""
    from ransacflow_tpu_torch.parallel import sharded_align_pairs
    from ransacflow_tpu_torch.parallel.mesh import draw_seeds, seeded_generators
    from ransacflow_tpu_torch.pipeline.fused import fused_align_batch

    _, _, resnet, align, pyramids, targets = serving
    pyr, tgt = tuple(map(torch.from_numpy, pyramids)), torch.from_numpy(targets)
    two = sharded_align_pairs(["cpu", "cpu"], resnet, align, pyr, tgt,
                              torch.Generator().manual_seed(4), n_iter=SERVE_ITER)
    one = sharded_align_pairs(["cpu"], resnet, align, pyr, tgt,
                              torch.Generator().manual_seed(4), n_iter=SERVE_ITER)
    seeds = draw_seeds(torch.Generator().manual_seed(4), WORLD)
    ref = fused_align_batch(resnet, align, pyr, tgt, seeded_generators(seeds, "cpu"),
                            n_iter=SERVE_ITER)
    _same(two, ref)
    _same(one, ref)
    assert two["H21"].shape == (WORLD, 3, 3) and bool(two["found"].all())
    with pytest.raises(ValueError, match="must divide the pair count"):
        sharded_align_pairs(["cpu"] * 3, resnet, align, pyr, tgt, n_iter=SERVE_ITER)


def _jax_sets(key, valid, n):
    """JAX's RANSAC draws under `key` over the valid matches, as match
    indices (tests/test_torch_pipeline.py's injection)."""
    from ransacflow_tpu.ops.ransac import _sample_minimal_sets

    raw, _ = _sample_minimal_sets(key, jnp.sum(valid.astype(jnp.int32)), 4, n)
    return np.asarray(jnp.argsort(~valid, stable=True)[raw]).astype(np.int32)


def test_sharded_align_pairs_matches_jax(serving):
    """Against JAX's `sharded_align_pairs` on a 2-device mesh, the port fed
    JAX's per-pair draws: found and inlier counts equal, H21 and the maps at
    the fused slice's tolerances (tests/test_torch_pipeline.py: 1e-4), the
    full-resolution matchability off the pixels whose grid lies on the
    border (within 1e-5 of +-1, where its in-bounds step flips on the last
    bit: 296 of 8192 here)."""
    from ransacflow_tpu.parallel import make_mesh, sharded_align_pairs as j_sharded
    from ransacflow_tpu.pipeline import fused as jfused
    from ransacflow_tpu_torch.parallel import sharded_align_pairs

    jr, ja, resnet, align, pyramids, targets = serving
    keys = jax.random.split(jax.random.PRNGKey(6), WORLD)
    ref = j_sharded(make_mesh(WORLD), jr, ja, tuple(map(jnp.asarray, pyramids)),
                    jnp.asarray(targets), keys, n_iter=SERVE_ITER)
    samples = []
    for k in range(WORLD):
        _, _, valid = jfused._coarse_match(jr, (jnp.asarray(pyramids[0][k]),),
                                           jnp.asarray(targets[k]))
        samples.append(_jax_sets(keys[k], valid, SERVE_ITER))
    got = sharded_align_pairs(["cpu", "cpu"], resnet, align,
                              tuple(map(torch.from_numpy, pyramids)), torch.from_numpy(targets),
                              injected_samples=torch.from_numpy(np.stack(samples)),
                              n_iter=SERVE_ITER)
    np.testing.assert_array_equal(got["found"].numpy(), np.asarray(ref["found"]))
    np.testing.assert_array_equal(got["num_inliers"].numpy(), np.asarray(ref["num_inliers"]))
    np.testing.assert_allclose(got["H21"].numpy(), np.asarray(ref["H21"]), atol=1e-4)
    for key in ("flow", "flow_down8", "match_down8"):
        assert got[key].shape == ref[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=1e-4,
                                   err_msg=key)
    # the full-resolution matchability is zero where the grid leaves [-1, 1]:
    # a step, which a 1e-7 difference of a grid lying on the border flips
    edge = np.abs(np.abs(got["flow"].numpy()[:, 0]) - 1).min(-1) < 1e-5
    assert edge.mean() < 0.1
    np.testing.assert_allclose(got["match"].numpy()[~edge], np.asarray(ref["match"])[~edge],
                               atol=1e-4)


def _planted(rng, n=200, inlier_frac=0.7):
    from ransacflow_tpu_torch.ops.homography import apply_homography

    H = torch.tensor([[1, 0, 0.3], [0, 1, -0.2], [0, 0, 1]], dtype=torch.float32)
    m2 = torch.from_numpy((rng.rand(n, 2) * 1.6 - 0.8).astype(np.float32))
    m1 = apply_homography(H, m2)
    n_out = int(n * (1 - inlier_frac))
    m1[:n_out] = torch.from_numpy((rng.rand(n_out, 2) * 1.6 - 0.8).astype(np.float32))
    ones = torch.ones((n, 1))
    valid = torch.ones(n, dtype=torch.bool)
    valid[-7:] = False
    return torch.cat([m1, ones], 1), torch.cat([m2, ones], 1), valid


def test_sharded_ransac_matches_jax(rng):
    """Against JAX's `sharded_ransac` on a 2-device mesh, each shard fed
    that device's JAX draws (its key of split(key, 2), ceil(n_iter / 2)
    sets): the winner's H21 to 1e-5, its count, found and inlier mask
    equal."""
    from ransacflow_tpu.parallel import make_mesh, sharded_ransac as j_sharded
    from ransacflow_tpu_torch.parallel import sharded_ransac

    m1, m2, valid = _planted(rng)
    key, n_iter = jax.random.PRNGKey(11), 301
    ref = j_sharded(make_mesh(WORLD), key, jnp.asarray(m1.numpy()), jnp.asarray(m2.numpy()),
                    jnp.asarray(valid.numpy()), 0.05, n_iter=n_iter)
    per = -(-n_iter // WORLD)
    sets = [torch.from_numpy(_jax_sets(k, jnp.asarray(valid.numpy()), per))
            for k in jax.random.split(key, WORLD)]
    got = sharded_ransac(["cpu", "cpu"], m1, m2, valid, 0.05, n_iter=n_iter,
                         injected_samples=sets)
    assert bool(got.found) == bool(ref.found) is True
    assert int(got.num_inliers) == int(ref.num_inliers)
    np.testing.assert_array_equal(got.inlier_mask.numpy(), np.asarray(ref.inlier_mask))
    np.testing.assert_allclose(got.H21.numpy(), np.asarray(ref.H21), atol=1e-5)


def test_sharded_ransac_tie_goes_to_the_first_device(rng):
    """Two shards that draw the same sets (in another order) tie on their
    best count: the winner is the first device's (argmax), its set and
    model; a second shard whose sets are all inliers wins."""
    from ransacflow_tpu_torch.ops.ransac import ransac_homography
    from ransacflow_tpu_torch.parallel import sharded_ransac

    m1, m2, valid = _planted(rng)
    sets = torch.from_numpy(rng.randint(0, 193, (64, 4)).astype(np.int32))
    sets[:, 0] = torch.from_numpy(rng.randint(0, 60, 64).astype(np.int32))  # an outlier each
    tied = sharded_ransac(["cpu", "cpu"], m1, m2, valid, 0.05, n_iter=128,
                          injected_samples=[sets, sets.flip(0)])
    first = ransac_homography(m1, m2, valid, 0.05, n_iter=64, injected_samples=sets)
    assert int(tied.num_inliers) == int(first.num_inliers)
    assert torch.equal(tied.best_sample, first.best_sample)
    inliers = torch.arange(int(200 * 0.3), 193, dtype=torch.int32)
    good = inliers[:4].repeat(64, 1)
    won = sharded_ransac(["cpu", "cpu"], m1, m2, valid, 0.05, n_iter=128,
                         injected_samples=[sets, good])
    assert torch.equal(won.best_sample, good[0]) and int(won.num_inliers) >= 130


def test_sharded_ransac_draws(rng):
    """The shards' draws: one seed a device from the caller's generator
    (`draw_seeds`); the sets they give are uniform over the valid matches
    and differ between devices, and injecting them reproduces the drawn fit
    bit for bit. Statistically, 4 shards of 512 find what one device's
    2048 hypotheses find (mean counts within 3)."""
    from ransacflow_tpu_torch.ops.ransac import ransac_homography, sample_minimal_sets
    from ransacflow_tpu_torch.parallel import sharded_ransac
    from ransacflow_tpu_torch.parallel.mesh import draw_seeds, seeded_generators

    m1, m2, valid = _planted(rng, inlier_frac=0.4)
    slots = ["cpu"] * 4
    seeds = draw_seeds(torch.Generator().manual_seed(8), 4)
    sets = [sample_minimal_sets(valid, 512, g) for g in seeded_generators(seeds, "cpu")]
    assert not any(torch.equal(sets[0], s) for s in sets[1:])
    drawn = sharded_ransac(slots, m1, m2, valid, 0.05, n_iter=2048,
                           generator=torch.Generator().manual_seed(8))
    injected = sharded_ransac(slots, m1, m2, valid, 0.05, n_iter=2048, injected_samples=sets)
    for a, b in zip(drawn, injected):
        assert torch.equal(a, b)
    many = [sample_minimal_sets(valid, 20000, g) for g in seeded_generators(seeds, "cpu")]
    hist = torch.bincount(torch.cat(many).flatten().long(), minlength=200).float()
    assert hist[193:].sum() == 0
    assert hist[:193].min() > 0.85 * hist[:193].mean() and hist.max() < 1.15 * hist[:193].mean()
    counts_sh, counts_one = [], []
    for seed in range(6):
        counts_sh.append(int(sharded_ransac(slots, m1, m2, valid, 0.05, n_iter=2048,
                                            generator=torch.Generator().manual_seed(seed))
                             .num_inliers))
        counts_one.append(int(ransac_homography(m1, m2, valid, 0.05, n_iter=2048,
                                                generator=torch.Generator().manual_seed(seed))
                              .num_inliers))
    assert abs(np.mean(counts_sh) - np.mean(counts_one)) <= 3.0


def test_mesh_replicate_and_shard_batch():
    """`make_mesh` takes the first n of a device list (repeats allowed) or
    of the machine's cards, raising, naming the count, when there are
    fewer; `replicate` gives one independent copy a device; `shard_batch`
    splits the leading axis into equal shards in order, and raises unless
    the mesh size divides it."""
    from ransacflow_tpu_torch.parallel import make_mesh, replicate, shard_batch

    assert make_mesh(2, ["cpu"] * 3) == [torch.device("cpu")] * 2
    assert make_mesh(devices=["cpu"]) == [torch.device("cpu")]
    have = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"a mesh of {have + 1} cuda devices: "
                                           f"this machine has {have}"):
        make_mesh(have + 1)
    with pytest.raises(RuntimeError, match="a mesh of 3 devices from a list of 2"):
        make_mesh(3, ["cpu", "cpu"])
    net = torch.nn.Linear(3, 2)
    copies = replicate({"a": net}, ["cpu", "cpu"])
    assert len(copies) == 2 and copies[0]["a"] is not copies[1]["a"] is not net
    assert all(torch.equal(c["a"].weight, net.weight) for c in copies)
    x = torch.arange(12.0).view(6, 2)
    shards = shard_batch(x, ["cpu"] * 3)
    assert [s.tolist() for s in shards] == [x[i:i + 2].tolist() for i in (0, 2, 4)]
    with pytest.raises(ValueError, match="must divide the batch"):
        shard_batch(x, ["cpu"] * 4)
