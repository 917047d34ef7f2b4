"""Parity of the port's data parallelism (`ransacflow_tpu_torch/parallel`,
the cross-rank training step, `fit` and `cli.train` over several ranks)
with the JAX package, on the CPU: ranks are processes joined by gloo
(`parallel.spawn`, a file store under the test's tmp_path), the JAX side
runs on the conftest's 8-device CPU mesh.

Every spawned group runs under its own time limit (`RANK_TIMEOUT`): a hung
collective kills the ranks and fails its test, never the whole run.

The data-parallel step is held by its REDUCED GRADIENTS to JAX's gradients
of the one large batch: Adam's first step is +-lr * sign(g), so the
parameters after it would hide a gradient scaled by the world size. The
gradients are compared with the correlation volume pinned to one value in
both packages (tests/test_torch_train.py's `_shared_corr` says why); on
JAX's side the pinned volume is each device's slice of it, picked by
`axis_index` inside the shard_map.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as ranks

from ransacflow_tpu.pipeline import init_alignment_params as j_init_align
from ransacflow_tpu_torch.kernels.correlation import correlation_volume
from ransacflow_tpu_torch.models.convert import alignment_params_from_tree
from ransacflow_tpu_torch.models.feature_extractor import feature_extractor
from ransacflow_tpu_torch.models.layers import l2_normalize
from ransacflow_tpu_torch.parallel import spawn
from ransacflow_tpu_torch.train import local_index_roll

IMG, MARGIN, K = ranks.IMG, ranks.MARGIN, ranks.K
WORLD, N_GLOBAL = 2, 2  # ranks, and pairs in the global batch (1 a rank, as JAX's test)
# seconds a spawned group may take before its ranks are killed and its test
# fails: each takes 12-21 s alone, and Tier-1 runs six test workers beside it
RANK_TIMEOUT = 300.0
TERMS = ("loss", "loss_lr", "loss_cycle", "loss_match", "loss_grad")
CASES = {
    "flow": dict(mode="flow", mu_cycle=1.0, lambda_match=0.0, grad_weight=0.0),
    "flow+match": dict(mode="flow+match", mu_cycle=1.0, lambda_match=0.01, grad_weight=1.0),
    "flow+match-bf16-remat": dict(mode="flow+match", mu_cycle=1.0, lambda_match=0.01,
                                  grad_weight=1.0, compute_dtype="bfloat16", remat=True),
}


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_train():
    """The JAX package's training modules, imported by the tests that use
    them: they import orbax, which the machine with the card lacks."""
    from ransacflow_tpu.train import losses, trainer

    return losses, trainer


def _np_tree(tree, rng):
    """The tree as numpy, BN statistics and affine moved off identity (as
    tests/test_torch_train.py's)."""
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
def setup():
    """(trees, the global batch concat(I1, I2), the shared correlation
    volume of that batch)."""
    rng = np.random.RandomState(0)
    trees = _np_tree(j_init_align(jax.random.PRNGKey(0)), rng)
    imgs = rng.rand(2 * N_GLOBAL, IMG, IMG, 3).astype(np.float32)
    nets = alignment_params_from_tree(trees, "cpu")
    with torch.no_grad():
        f = l2_normalize(feature_extractor(nets["netFeatCoarse"], torch.from_numpy(imgs)))
        corr = correlation_volume(f[local_index_roll(N_GLOBAL, "cpu")], f, K).numpy()
    return trees, imgs, corr


def _bn_and_ssim_inputs():
    rng = np.random.RandomState(3)
    x = rng.randn(4, 6, 5, 7).astype(np.float32) * 2 + 0.5
    g = rng.randn(*x.shape).astype(np.float32)
    img1 = rng.rand(4, 20, 24, 3).astype(np.float32)
    img2 = np.clip(img1 + 0.1 * rng.rand(*img1.shape), 0, 1).astype(np.float32)
    match = np.zeros((4, 20, 24, 1), np.float32)
    match[:, 4:16, 5:19] = rng.rand(4, 12, 14, 1)
    return (x, g), (img1, img2, match)


def _groups_data(root):
    """The training groups `fit` and the CLI read: 5 groups of 2 views (so
    the 2-rank shards pad one group by wrapping)."""
    from PIL import Image

    rng = np.random.RandomState(1)
    os.makedirs(root)
    for idx in range(5):
        for v in (1, 2):
            arr = (rng.rand(48, 56, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(root, f"{idx}_{v}.jpg"))
    return root


FIT_KW = dict(mode="flow+match", mu_cycle=1.0, lambda_match=0.01, epochs=1, batch_size=2,
              img_size=IMG, margin=MARGIN, kernel_size=K, seed=0, log_every=1,
              max_steps_per_epoch=2, epoch_save_model=1)


def _cli_two_ranks(data, out):
    cmd = [sys.executable, "-m", "ransacflow_tpu_torch.cli.train", "--trainImgDir", data,
           "--outDir", out, "--stage", "3", "--batchSize", "2", "--imgSize", str(IMG),
           "--margin", str(MARGIN), "--nEpochs", "1", "--maxStepsPerEpoch", "2",
           "--device", "cpu", "--nDevices", str(WORLD), "NoVal", "--epochSaveModel", "1"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(cmd, capture_output=True, text=True, timeout=RANK_TIMEOUT, env=env)


@pytest.fixture(scope="module")
def groups(setup, tmp_path_factory):
    """The spawned groups of this file, started together in the background
    (each under RANK_TIMEOUT) while the JAX references compile: {name:
    future}. 'world2' runs every case of CASES with the correlation pinned,
    the synced BatchNorm and K10's global form; 'fit' runs `fit` on 2 ranks;
    'cli' `cli.train --nDevices 2` in a subprocess; 'dryrun' the world-4
    twin of `dryrun_multichip`."""
    from concurrent.futures import ThreadPoolExecutor

    trees, imgs, corr = setup
    root = tmp_path_factory.mktemp("parallel")
    data = _groups_data(str(root / "data"))
    cases = [dict(CASES[name], pinned=True) for name in CASES]
    bn, ssim = _bn_and_ssim_inputs()
    outs = [str(root / f"fit_rank{r}") for r in range(WORLD)]
    ex = ThreadPoolExecutor(max_workers=4)
    futures = {
        "world2": ex.submit(spawn, ranks.world2, ["cpu"] * WORLD, "gloo",
                            (trees, imgs, corr, cases, bn, ssim), RANK_TIMEOUT),
        "fit": ex.submit(spawn, ranks.fit_rank, ["cpu"] * WORLD, "gloo",
                         (trees, data, outs, FIT_KW), RANK_TIMEOUT),
        "cli": ex.submit(_cli_two_ranks, data, str(root / "cli")),
        "dryrun": ex.submit(spawn, ranks.dryrun, ["cpu"] * 4, "gloo", (trees,), RANK_TIMEOUT),
    }
    futures["paths"] = (data, outs, str(root / "cli"))
    yield futures
    ex.shutdown(wait=True)


@pytest.fixture(scope="module")
def world2(groups):
    return groups["world2"].result()


@pytest.fixture(scope="module")
def single(setup):
    """The port's single-process step on the global batch, each case."""
    trees, imgs, corr = setup
    return {name: ranks.step_case(trees, imgs, corr, dict(case, pinned=True), "cpu", None)
            for name, case in CASES.items()}


def _leaf(tree, name):
    for part in name.split("."):
        tree = tree[part]
    a = np.asarray(tree)
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a  # HWIO -> OIHW


def _jax_pinned(jlosses, corr_of):
    """`jlosses.correlation_volume` pinned to corr_of() (evaluated at trace
    time, inside the shard_map for the DP step)."""
    orig = jlosses.correlation_volume

    def pinned(x, y, k):
        c = orig(x, y, k)
        return corr_of() + (c - jax.lax.stop_gradient(c))

    return orig, pinned


@pytest.fixture(scope="module")
def jax_refs(setup, groups):
    """{mode: (JAX's gradients of the one large batch, its DP step's new
    params and metrics)}, the correlation pinned in both."""
    from ransacflow_tpu.ops.grid import normalized_grid
    from ransacflow_tpu.parallel import make_mesh, replicate, shard_batch

    jlosses, jtrainer = _jax_train()
    trees, imgs, corr = setup
    params = jax.tree.map(jnp.asarray, trees)
    grid = normalized_grid(IMG, IMG)[None]
    mesh = make_mesh(WORLD)
    b = N_GLOBAL // WORLD
    rows = np.concatenate([ranks.local_rows(N_GLOBAL, r, WORLD) for r in range(WORLD)])
    corr_dp = jnp.asarray(corr[rows].reshape(WORLD, 2 * b, *corr.shape[1:]))
    out = {}
    for name in ("flow", "flow+match"):
        kw = dict(CASES[name], kernel_size=K)
        trainable, frozen = jtrainer.split_trainable(params, kw["mode"])

        def loss_fn(tr):
            return jlosses.compute_losses(
                {**frozen, **tr}, jnp.asarray(imgs), jtrainer.local_index_roll(N_GLOBAL), grid,
                jlosses.margin_mask(2 * N_GLOBAL, IMG, MARGIN), **kw)

        orig, pinned = _jax_pinned(jlosses, lambda: jnp.asarray(corr))
        jlosses.correlation_volume = pinned
        try:
            (_, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(trainable)
        finally:
            jlosses.correlation_volume = orig

        init_opt, _ = jtrainer.make_train_step(**kw)
        dp_step = jtrainer.make_data_parallel_step(mesh, **kw)
        mask = jnp.tile(jlosses.margin_mask(2 * b, IMG, MARGIN), (WORLD, 1, 1, 1))
        orig, pinned = _jax_pinned(jlosses, lambda: corr_dp[jax.lax.axis_index("data")])
        jlosses.correlation_volume = pinned
        try:
            new_p, _, metrics = dp_step(
                replicate(params, mesh), replicate(init_opt(params), mesh),
                shard_batch(jnp.asarray(imgs[rows]), mesh), jtrainer.local_index_roll(b),
                replicate(grid, mesh), shard_batch(mask, mesh))
        finally:
            jlosses.correlation_volume = orig
        opt = jtrainer.make_optimizer(2e-4)
        adam_of = {}
        for scale in (1, WORLD):
            g = jax.tree.map(lambda x: scale * x, grads)
            upd, _ = opt.update(g, opt.init(trainable), trainable)
            adam_of[scale] = {k: v for k, v in optax_apply(trainable, upd).items()
                              if k in trainable}
        out[name] = (grads, adam_of, new_p, {k: float(v) for k, v in metrics.items()})
    return out


def optax_apply(params, updates):
    import optax

    return optax.apply_updates(params, updates)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("name", ["flow", "flow+match"])
def test_dp_step_matches_jax(jax_refs, world2, name):
    """The world-2 step against JAX: the reduced gradient of each trainable
    tensor (equal on both ranks) against JAX's gradient of the one large
    batch to 1e-4 of its largest magnitude; the losses against JAX's
    `make_data_parallel_step` to a relative 1e-5 and the trained networks'
    BatchNorm statistics to 1e-5 (tests/test_torch_train.py's tolerances);
    the parameters after one Adam step against optax's Adam on JAX's
    gradient, to 1e-6 but for at most 0.1% of them (about 0.02% differ, by
    up to 2 lr: Adam's first step is +-lr sign(g), and near-zero gradients
    differ in sign within their 1e-4 tolerance; JAX's own DP test allows 2%
    at 1e-5)."""
    i = list(CASES).index(name)
    got = [r["cases"][i] for r in world2]
    grads_j, adam_of, new_p, metrics_j = jax_refs[name]
    mode = CASES[name]["mode"]
    assert got[0]["grads"].keys() == got[1]["grads"].keys()
    n = 0
    for key, g in got[0]["grads"].items():
        np.testing.assert_array_equal(g, got[1]["grads"][key], err_msg=key)
        net, pname = key.split(".", 1)
        ref = _leaf(grads_j[net], pname)
        np.testing.assert_allclose(g, ref, atol=1e-4 * np.abs(ref).max(), rtol=0, err_msg=key)
        n += 1
    assert n == sum(1 for k in _flat(grads_j) if not k.endswith(("running_mean", "running_var")))
    for k in TERMS:
        for r in got:
            np.testing.assert_allclose(r["metrics"][k], metrics_j[k], rtol=1e-5, atol=1e-9,
                                       err_msg=k)
    flat_p = {k: np.asarray(v) for k, v in _flat(new_p).items()}
    n_bn = 0
    for key, v in got[0]["bn"].items():
        if key.endswith(("running_mean", "running_var")) and key.split(".")[0] in mode_nets(mode):
            np.testing.assert_allclose(v, flat_p[key], rtol=1e-5, atol=1e-6, err_msg=key)
            n_bn += 1
    assert n_bn > 0
    # JAX's DP step applies Adam to W times the global gradient (its psum'd
    # partials of a psum'd ratio, check_vma=False: psum's transpose is psum):
    # a divergence of the reference (ROADMAP.md queue 3). The port's step is
    # Adam on the gradient itself, held here; JAX's is pinned to its scale.
    port = {k: v.transpose(2, 3, 1, 0) if v.ndim == 4 else v  # OIHW -> HWIO
            for k, v in got[0]["params"].items()}
    for params, ref, scale in ((port, adam_of[1], "the port's"),
                               (_flat(new_p), adam_of[WORLD], "JAX's DP")):
        mismatched = total = 0
        for key, r in _flat(ref).items():
            if key.endswith(("running_mean", "running_var")):
                continue
            v = np.asarray(params[key])
            mismatched += int((np.abs(v - np.asarray(r)) > 1e-6).sum())
            total += v.size
        assert mismatched <= 1e-3 * total, (
            f"{scale} step: {mismatched} of {total} parameters differ by > 1e-6")
    for key, v in got[0]["params"].items():
        np.testing.assert_array_equal(v, got[1]["params"][key], err_msg=key)


def mode_nets(mode):
    return _jax_train()[0].TRAIN_MODULES[mode]


def _close_cases(got, ref, grad_tol, loss_rtol, bn_tol):
    for key, g in got["grads"].items():
        r = ref["grads"][key]
        np.testing.assert_allclose(g, r, atol=grad_tol * np.abs(r).max(), rtol=0, err_msg=key)
    assert got["grads"].keys() == ref["grads"].keys()
    for k in TERMS:
        np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k], rtol=loss_rtol,
                                   atol=1e-9, err_msg=k)
    for key, v in ref["bn"].items():
        if key.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got["bn"][key], v, err_msg=key)
        else:
            np.testing.assert_allclose(got["bn"][key], v, rtol=bn_tol, atol=bn_tol, err_msg=key)


@pytest.mark.parametrize("name", ["flow", "flow+match"])
def test_dp_step_equals_one_large_batch(world2, single, name):
    """Within the port: the world-2 step equals the single-process step on
    the global batch. The reduced gradients to 1e-4 of each tensor's largest
    magnitude, the losses to a relative 1e-5, the BatchNorm statistics to
    1e-5 (the synced moments are E[x^2] - E[x]^2 over the ranks, the
    single step's `nn.BatchNorm2d` their two-pass form)."""
    i = list(CASES).index(name)
    for r in world2:
        _close_cases(r["cases"][i], single[name], 1e-4, 1e-5, 1e-5)


def test_dp_step_bf16_remat_equals_one_large_batch(world2, single):
    """Under compute_dtype='bfloat16' and remat=True, the world-2 step
    against the port's single-process bf16 remat step (the analogue of JAX's
    tests/test_train.py:274). bf16 convolutions round at 2^-8, so a
    last-bit difference of the synced moments flips roundings downstream:
    on the CPU a 1e-6 change of the images alone moves the single step's
    gradients by a median 18% of each tensor's largest magnitude (cosine
    >= 0.966) and its statistics by 1.8e-3. So: the losses to a relative
    2e-3, the statistics to 5e-3, and each gradient by direction and size,
    cosine >= 0.9 and norm within 20% (a world-size factor would be 2 or
    1/2); the fp32 masters stay fp32."""
    name = "flow+match-bf16-remat"
    i = list(CASES).index(name)
    ref = single[name]
    for r in world2:
        got = r["cases"][i]
        assert got["grads"].keys() == ref["grads"].keys()
        for k, v in ref["grads"].items():
            g = got["grads"][k]
            cos = float((g * v).sum() / np.linalg.norm(g) / np.linalg.norm(v))
            ratio = float(np.linalg.norm(g) / np.linalg.norm(v))
            assert cos >= 0.9 and 0.8 <= ratio <= 1.25, (k, cos, ratio)
        for k in TERMS:
            np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k], rtol=2e-3,
                                       err_msg=k)
        for k, v in ref["bn"].items():
            np.testing.assert_allclose(got["bn"][k], v, atol=5e-3, rtol=0, err_msg=k)
        assert all(v.dtype == np.float32 for v in got["params"].values())


def _bn_reference(x, g, rows=slice(None)):
    bn = torch.nn.BatchNorm2d(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, x.shape[1]))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, x.shape[1]))
    xt = torch.from_numpy(x[rows]).requires_grad_()
    y = bn.train()(xt)
    y.backward(torch.from_numpy(g[rows]))
    return {"y": y.detach().numpy(), "dx": xt.grad.numpy(),
            "dwb": torch.stack([bn.weight.grad, bn.bias.grad]).numpy(),
            "stats": torch.stack([bn.running_mean, bn.running_var]).numpy()}


def test_synced_batch_norm(world2):
    """The synced BatchNorm on two ranks against `nn.BatchNorm2d` on the
    concatenated batch: the output and the input gradient of each rank's
    rows, the weight and bias gradients summed over the ranks, the running
    statistics (unbiased over the global count) on both ranks, within fp32
    rounding (1e-5). Under a group of one rank, and with no group, it is
    the `nn.BatchNorm2d` call bit for bit."""
    (x, g), _ = _bn_and_ssim_inputs()
    ref = _bn_reference(x, g)
    b = len(x) // WORLD
    for rank, r in enumerate(world2):
        got = r["bn"]
        rows = slice(rank * b, (rank + 1) * b)
        np.testing.assert_allclose(got["y"], ref["y"][rows], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got["dx"], ref["dx"][rows], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got["dwb"], ref["dwb"], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got["stats"], ref["stats"], atol=1e-6, rtol=1e-5)
        assert got["count"] == 1
    alone = _bn_reference(x, g, slice(0, 2))
    for r in world2:
        for k, v in alone.items():
            np.testing.assert_array_equal(r["bn_alone"][k], v, err_msg=k)
    no_group = ranks.synced_bn(0, 1, x[:2], g[:2], None)
    for k, v in alone.items():
        np.testing.assert_array_equal(no_group[k], v, err_msg=k)


def test_masked_ssim_global_matches_jax(world2):
    """K10's global form (its plain twin here) on two ranks against
    `ransacflow_tpu.ops.ssim.masked_ssim_loss(axis_name='data')` under
    shard_map on two devices: the loss (the global ratio, equal on both
    ranks) to a relative 1e-5, and each rank's gradient against JAX's
    gradient of the shard_map'd loss to 1e-5 of its largest magnitude. A
    rank's backward gives the world size times its share (the convention of
    `parallel.group`: its loss is the global one, and `reduce_grads`
    averages), so its gradient over WORLD is held to JAX's."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from ransacflow_tpu.ops.ssim import masked_ssim_loss
    from ransacflow_tpu.parallel import make_mesh

    _, (img1, img2, match) = _bn_and_ssim_inputs()
    f = shard_map(lambda a, b, m: masked_ssim_loss(a, b, m, axis_name="data"),
                  mesh=make_mesh(WORLD), in_specs=(P("data"),) * 3, out_specs=P(),
                  check_vma=False)
    loss_j, grad_j = jax.jit(jax.value_and_grad(
        lambda a: f(a, jnp.asarray(img2), jnp.asarray(match))))(jnp.asarray(img1))
    grad_j = np.asarray(grad_j)
    b = len(img1) // WORLD
    for rank, r in enumerate(world2):
        loss, grad = r["ssim"]
        np.testing.assert_allclose(loss, float(loss_j), rtol=1e-5)
        ref = grad_j[rank * b:(rank + 1) * b]
        np.testing.assert_allclose(grad / WORLD, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


LAYOUTS = [(16, 4, 0, 1), (16, 4, 1, 4), (16, 4, 3, 4), (64, 8, 1, 2), (12, 4, 0, 2),
           (16, 4, 0, 3), (10, 4, 0, 2), (16, 4, 4, 4), (16, 4, -1, 4), (16, 4, 0, 0)]


def test_process_shard_layout_matches_jax():
    """The port's copy against `ransacflow_tpu.train.loop.process_shard_layout`
    over a grid of layouts, its three errors included."""
    from ransacflow_tpu.train.loop import process_shard_layout as j_layout
    from ransacflow_tpu_torch.train import process_shard_layout

    n_errors = 0
    for case in LAYOUTS:
        try:
            want = j_layout(*case)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                process_shard_layout(*case)
            assert str(got.value) == str(e)
            n_errors += 1
            continue
        assert process_shard_layout(*case) == want, case
    assert n_errors == 5


@pytest.mark.parametrize("n_groups", [5, 8])
def test_pair_folder_shards_match_jax(tmp_path, n_groups):
    """`PairFolder(shard_index, num_shards)` against the JAX package's
    (tests/test_train.py:210): the same indices for 1-4 shards, shards of
    equal length covering every group, the padding by wrapping."""
    from PIL import Image
    from ransacflow_tpu.train.data import PairFolder as JPairFolder
    from ransacflow_tpu_torch.train import PairFolder

    rng = np.random.RandomState(2)
    for idx in range(n_groups):
        for v in (1, 2):
            Image.fromarray((rng.rand(16, 16, 3) * 255).astype(np.uint8)).save(
                tmp_path / f"{idx}_{v}.jpg")
    for n in range(1, 5):
        shards = [PairFolder(str(tmp_path), img_size=8, shard_index=i, num_shards=n).indices
                  for i in range(n)]
        for i, got in enumerate(shards):
            assert got == JPairFolder(str(tmp_path), img_size=8, shard_index=i,
                                      num_shards=n).indices
        assert len({len(s) for s in shards}) == 1
        assert set().union(*shards) == set(range(n_groups))


def test_fit_two_ranks(groups, setup):
    """`fit(n_devices=2)` on two gloo ranks, rank 1 starting from other
    weights, 2 steps of stage 3: both ranks end with equal networks (rank
    0's broadcast start, equal reduced gradients), only rank 0 writes (its
    metrics and checkpoint; rank 1's out_dir is never made), and the
    checkpoint holds rank 0's networks."""
    from ransacflow_tpu_torch.train import load_checkpoint

    states = groups["fit"].result()
    _, outs, _ = groups["paths"]
    for k, v in states[0].items():
        assert torch.equal(v, states[1][k]), k
    assert ranks.files_of(outs[1]) == []
    assert ranks.files_of(outs[0]) == ["checkpoint_epoch0.pt", "metrics.jsonl"]
    recs = ranks.read_metrics(outs[0])
    assert [r["step"] for r in recs] == [1, 2, 0] and all(np.isfinite(r["loss"]) for r in recs)
    ckpt = load_checkpoint(os.path.join(outs[0], "checkpoint_epoch0.pt"))
    for name, sd in ckpt["nets"].items():
        for k, v in sd.items():
            assert torch.equal(v, states[0][f"{name}.{k}"]), (name, k)
    trees = setup[0]
    start = alignment_params_from_tree(trees, "cpu")["netFeatCoarse"].conv1.weight
    assert not torch.equal(states[0]["netFeatCoarse.conv1.weight"], start)  # it trained


def test_cli_train_two_ranks(groups):
    """`python -m ransacflow_tpu_torch.cli.train --device cpu --nDevices 2
    --stage 3 ... NoVal` in a subprocess: two spawned gloo ranks, rank 0's
    metrics and checkpoint, loadable."""
    from ransacflow_tpu_torch.train import load_checkpoint

    proc = groups["cli"].result()
    _, _, out = groups["paths"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = ranks.read_metrics(out)
    assert recs[-1]["step"] == 0 and np.isfinite(recs[-1]["loss"])
    ckpt = load_checkpoint(os.path.join(out, "checkpoint_epoch0.pt"))
    assert ckpt["step"] == 0 and set(ckpt["nets"]) == {"netFeatCoarse", "netFlowCoarse",
                                                       "netMatch"}


def test_dryrun_multichip_gloo_twin(groups):
    """`__graft_entry__.dryrun_multichip`'s four layouts on 4 gloo ranks and
    4 CPU slots: the data-parallel stage-3 step (finite loss, equal on every
    rank, equal networks after it), sharded RANSAC (found, most of 64
    planted inliers), the pooled batched eval over a 4-slot pool (every pair
    predicted, finite) and sharded serving with adaptive RANSAC (finite, K
    leading)."""
    res = groups["dryrun"].result()
    assert len({r["loss"] for r in res}) == 1 and np.isfinite(res[0]["loss"])
    assert len({r["param_sum"] for r in res}) == 1
    found, count = res[0]["ransac"]
    assert found and count >= 60
    assert sorted(res[0]["pooled"]) == list(range(8)) and all(res[0]["pooled"].values())
    served = res[0]["served"]
    assert served["H21"][0] == (4, 3, 3) and served["flow"][0] == (4, 1, 32, 32, 2)
    assert all(ok for _, ok in served.values())
