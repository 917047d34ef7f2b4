"""Parity of the PyTorch port's training slice with the JAX package, on the
CPU, at the shapes of tests/test_train.py (IMG 32, margin 8, B 2, k 7).

The same numpy-seeded images and the JAX-initialized weights (moved with
`models.convert.alignment_params_from_tree`) go through both packages. The
kernel wrappers take their plain versions for CPU tensors, so these tests
hold the plain versions and their autograd against JAX; the `gpu` test
holds a train step on the card against the port on the CPU.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from ransacflow_tpu.models import heads as jheads
from ransacflow_tpu.ops import blurpool as jblur
from ransacflow_tpu.ops import correlation as jcorr
from ransacflow_tpu.ops import grid as jgrid
from ransacflow_tpu.ops import sampler as jsampler
from ransacflow_tpu.ops import ssim as jssim
from ransacflow_tpu.pipeline import init_alignment_params as j_init_align
from ransacflow_tpu_torch.cli import train as cli_train
from ransacflow_tpu_torch.kernels.blurpool import binomial_filter, blur_pool
from ransacflow_tpu_torch.kernels.correlation import correlation_volume
from ransacflow_tpu_torch.kernels.ssim import (
    gaussian_window,
    masked_ssim_grad_ref,
    masked_ssim_loss,
    ssim_partials_ref,
)
from ransacflow_tpu_torch.kernels.warp_sample import warp_sample
from ransacflow_tpu_torch.models.convert import alignment_params_from_tree, init_alignment_params
from ransacflow_tpu_torch.models.heads import flow_gradient_magnitude, flow_to_grid
from ransacflow_tpu_torch.ops.grid import normalized_grid
from ransacflow_tpu_torch.train import (
    STAGES,
    TRAIN_MODULES,
    PairFolder,
    compute_losses,
    fit,
    load_checkpoint,
    local_index_roll,
    make_optimizer,
    margin_mask,
    split_trainable,
    train_step,
)

IMG, MARGIN, B, K = 32, 8, 2, 7
LOSS_KW = dict(mu_cycle=1.0, lambda_match=0.01, grad_weight=1.0, kernel_size=K)
MODES = ("flow", "flow+match", "grad")
TERMS = ("loss_lr", "loss_cycle", "loss_match", "loss_grad")


def _jax_train():
    """The JAX package's training modules, imported by the tests that use
    them: they import orbax, which the machine with the card lacks."""
    from ransacflow_tpu.train import data, loop, losses, trainer

    return data, loop, losses, trainer


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np_tree(tree, rng):
    """The tree as numpy, BN statistics and affine moved off identity so that
    the eval-mode (frozen) networks exercise them."""
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
    rng = np.random.RandomState(0)
    trees = _np_tree(j_init_align(jax.random.PRNGKey(0)), rng)
    imgs = rng.rand(2 * B, IMG, IMG, 3).astype(np.float32)
    return trees, imgs


def _jax_batch(imgs):
    _, _, jlosses, jtrainer = _jax_train()
    return (jnp.asarray(imgs), jtrainer.local_index_roll(B),
            jgrid.normalized_grid(IMG, IMG)[None], jlosses.margin_mask(2 * B, IMG, MARGIN))


def _torch_batch(imgs, device="cpu"):
    return (t(imgs).to(device), local_index_roll(B, device),
            normalized_grid(IMG, IMG, device)[None], margin_mask(2 * B, IMG, MARGIN, device))


def _jax_losses(trees, imgs, mode, corr=None):
    """(loss, aux, grads) of the JAX losses at `trees`; with `corr`, the
    correlation volume takes that value, its gradient still flowing into the
    features through the JAX correlation (see `_shared_corr`)."""
    _, _, jlosses, jtrainer = _jax_train()
    params = jax.tree.map(jnp.asarray, trees)
    trainable, frozen = jtrainer.split_trainable(params, mode)

    def loss_fn(tr):
        return jlosses.compute_losses({**frozen, **tr}, *_jax_batch(imgs), mode=mode,
                                      **LOSS_KW)

    orig = jlosses.correlation_volume
    if corr is not None:
        def pinned(x, y, k):
            c = orig(x, y, k)
            return jnp.asarray(corr) + (c - jax.lax.stop_gradient(c))
        jlosses.correlation_volume = pinned
    try:
        (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(trainable)
    finally:
        jlosses.correlation_volume = orig
    return loss, aux, grads


@pytest.fixture(scope="module")
def jax_grads(setup):
    """{mode: (loss, aux, grads)} at the shared weights: end to end, and
    with the correlation volume pinned to the shared value."""
    trees, imgs = setup
    return {mode: (_jax_losses(trees, imgs, mode),
                   _jax_losses(trees, imgs, mode, _shared_corr(trees, imgs)))
            for mode in MODES}


def _shared_corr(trees, imgs):
    """The correlation volume both packages evaluate the heads at for the
    gradient comparison: the port's own, from the feature network in eval
    mode, on the CPU, as numpy.

    Why: at this size the heads' train-mode BatchNorm (64 cells a channel)
    and their ReLU kinks make the weight gradients ill-conditioned in the
    correlation volume the train-mode feature network gives: noise of 3e-6
    in it, the difference two fp32 convolution libraries leave, moves JAX's
    own head gradients by up to a few percent, and so does the order in
    which XLA happens to sum. At the eval-mode volume the same noise moves
    them by 1e-5. So both packages run the heads and the losses at this one
    value, and each differentiates through its own feature network (in the
    mode's BN mode) and its own correlation.
    """
    from ransacflow_tpu_torch.models.feature_extractor import feature_extractor
    from ransacflow_tpu_torch.models.layers import l2_normalize

    nets = alignment_params_from_tree(trees, "cpu")
    with torch.no_grad():
        f = l2_normalize(feature_extractor(nets["netFeatCoarse"], t(imgs)))
        return correlation_volume(f[local_index_roll(B, "cpu")], f, K).numpy()


def _port_losses(trees, imgs, mode, corr=None, monkeypatch=None):
    """The port's losses (backward run) at `trees`, `corr` pinned as in
    `_jax_losses`. Returns (nets, loss, terms)."""
    from ransacflow_tpu_torch.train import losses

    if corr is not None:
        orig = losses.correlation_volume

        def pinned(x, y, k):
            c = orig(x, y, k)
            return torch.from_numpy(corr) + (c - c.detach())
        monkeypatch.setattr(losses, "correlation_volume", pinned)
    nets = alignment_params_from_tree(trees, "cpu")
    loss, terms = compute_losses(nets, *_torch_batch(imgs), mode=mode, **LOSS_KW)
    loss.backward()
    if corr is not None:
        monkeypatch.undo()
    return nets, loss.detach(), terms


def _leaf(tree, name):
    for part in name.split("."):
        tree = tree[part]
    a = np.asarray(tree)
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a  # HWIO -> OIHW


@pytest.mark.parametrize("mode", MODES)
def test_compute_losses_and_gradients_match_jax(setup, jax_grads, mode, monkeypatch):
    """End to end, each loss term to a relative 1e-5 and the BN running
    statistics the trained networks moved. Every trainable gradient to 1e-4
    of its tensor's largest magnitude, both packages evaluating the heads at
    the same correlation volume (`_shared_corr` says why)."""
    trees, imgs = setup
    assert TRAIN_MODULES == _jax_train()[2].TRAIN_MODULES
    (loss_j, aux_j, _), (_, _, grads_j) = jax_grads[mode]
    nets, loss, terms = _port_losses(trees, imgs, mode)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    for k in TERMS:
        np.testing.assert_allclose(terms[k].item(), float(aux_j[k]), rtol=1e-5, atol=1e-9)
    if mode == "flow":
        assert float(terms["loss_match"]) == float(terms["loss_grad"]) == 0.0
    for name, stats in aux_j["bn_stats"].items():
        bufs = dict(nets[name].named_buffers())
        flat = {}

        def walk(prefix, node):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(f"{prefix}{k}.", v)
                else:
                    flat[prefix + k] = np.asarray(v)
        walk("", stats)
        assert flat
        for key, ref in flat.items():
            np.testing.assert_allclose(bufs[key].numpy(), ref, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name}.{key}")
    # frozen networks ran in eval mode: their statistics did not move
    for name in set(nets) - set(TRAIN_MODULES[mode]):
        assert name not in aux_j["bn_stats"]
        for key, buf in nets[name].named_buffers():
            if key.endswith("running_mean"):
                np.testing.assert_array_equal(buf.numpy(), _leaf(trees[name], key))

    nets, _, _ = _port_losses(trees, imgs, mode, _shared_corr(trees, imgs), monkeypatch)
    trainable, frozen = split_trainable(nets, mode)
    assert all(p.grad is None for p in frozen)
    n = 0
    for name in TRAIN_MODULES[mode]:
        for pname, p in nets[name].named_parameters():
            ref = _leaf(grads_j[name], pname)
            np.testing.assert_allclose(p.grad.numpy(), ref, atol=1e-4 * np.abs(ref).max(),
                                       rtol=0, err_msg=f"{name}.{pname}")
            n += 1
    assert n == len(trainable)


def test_adam_step_matches_optax(setup, jax_grads):
    """One Adam step fed JAX's own gradients: the optimizer alone. The
    updates to 1e-7 (each weight's own fp32 rounding is below 6e-8 here)."""
    trees, _ = setup
    _, _, _, jtrainer = _jax_train()
    _, (_, _, grads) = jax_grads["flow+match"]
    params = jax.tree.map(jnp.asarray, trees)
    trainable, _ = jtrainer.split_trainable(params, "flow+match")
    opt_j = jtrainer.make_optimizer(2e-4)
    updates, _ = opt_j.update(grads, opt_j.init(trainable), trainable)
    nets = alignment_params_from_tree(trees, "cpu")
    opt = make_optimizer(split_trainable(nets, "flow+match")[0], 2e-4)
    before = {}
    for name in TRAIN_MODULES["flow+match"]:
        for pname, p in nets[name].named_parameters():
            p.grad = torch.from_numpy(np.array(_leaf(grads[name], pname)))
            before[name, pname] = p.detach().clone()
    opt.step()
    for name in TRAIN_MODULES["flow+match"]:
        for pname, p in nets[name].named_parameters():
            step = (p.detach() - before[name, pname]).numpy()
            ref = _leaf(updates[name], pname)
            assert np.abs(ref).max() > 1e-4  # ~lr: Adam's first step
            np.testing.assert_allclose(step, ref, atol=1e-7, rtol=0,
                                       err_msg=f"{name}.{pname}")


def _groups(folder, rng, n=6):
    for idx in range(n):
        for v in (1, 2):
            arr = (rng.rand(48, 56, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(folder, f"{idx}_{v}.jpg"))


def test_fit_three_steps_matches_jax(setup, tmp_path):
    """`fit` on both packages over the same folder and seed: 3 steps of
    stage 3 (flow+match), the running loss averages of every step. The
    first step's losses to a relative 1e-5; the later ones to 1e-2: Adam's
    first steps move each weight by about +-lr whatever its gradient's size,
    and the end-to-end gradients of near-zero weights differ in sign between
    two fp32 implementations at this size (`_shared_corr` says why), so the
    trajectories part by up to 2 lr per such weight."""
    trees, _ = setup
    data = tmp_path / "data"
    data.mkdir()
    _groups(str(data), np.random.RandomState(1))
    kw = dict(mode="flow+match", mu_cycle=1.0, lambda_match=0.01, grad_weight=0.0,
              epochs=1, batch_size=B, img_size=IMG, margin=MARGIN, kernel_size=K,
              seed=0, log_every=1, max_steps_per_epoch=3)
    _jax_train()[1].fit(jax.tree.map(jnp.asarray, trees), str(data), str(tmp_path / "jax"), **kw)
    fit(alignment_params_from_tree(trees, "cpu"), str(data), str(tmp_path / "torch"),
        "cpu", **kw)
    recs = [[json.loads(line) for line in open(tmp_path / d / "metrics.jsonl")]
            for d in ("jax", "torch")]
    assert [r["step"] for r in recs[0]] == [r["step"] for r in recs[1]] == [1, 2, 3, 0]
    for i, (rj, rt) in enumerate(zip(*recs)):
        for k in ("loss", *TERMS):
            np.testing.assert_allclose(rt[k], rj[k], rtol=1e-5 if i == 0 else 1e-2,
                                       atol=1e-8, err_msg=f"step {rj['step']} {k}")
    assert recs[1][2]["loss"] != recs[1][0]["loss"]  # the weights moved


def _vjp_check(jax_fn, torch_fn, args, cot, atol):
    """Plain autograd of `torch_fn` against `jax.vjp` of `jax_fn`, all args."""
    out_j, vjp = jax.vjp(jax_fn, *map(jnp.asarray, args))
    grads_j = vjp(jnp.asarray(cot))
    targs = [t(a).requires_grad_() for a in args]
    out = torch_fn(*targs)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=atol)
    out.backward(t(cot))
    for a, g in zip(targs, grads_j):
        ours = np.zeros_like(np.asarray(g)) if a.grad is None else a.grad.numpy()
        np.testing.assert_allclose(ours, np.asarray(g), atol=atol, rtol=1e-5)


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_grid_sample_autograd_matches_jax_vjp(channels):
    """The image cotangent (a splat) and the grid cotangent, points inside,
    on +-1 and outside the image."""
    rng = np.random.RandomState(channels)
    img = rng.rand(2, 9, 11, channels).astype(np.float32)
    g = rng.uniform(-1.2, 1.2, (2, 7, 8, 2)).astype(np.float32)
    g[0, 0, :3] = [[-1, -1], [1, 1], [1, -0.3]]
    cot = rng.randn(2, 7, 8, channels).astype(np.float32)
    _vjp_check(jsampler.grid_sample, warp_sample, (img, g), cot, atol=1e-5)


def test_correlation_autograd_matches_jax_vjp():
    rng = np.random.RandomState(4)
    x, y = (rng.randn(2, 5, 6, 8).astype(np.float32) for _ in range(2))
    cot = rng.randn(2, 5, 6, K * K).astype(np.float32)
    _vjp_check(lambda a, b: jcorr.correlation_volume(a, b, K),
               lambda a, b: correlation_volume(a, b, K), (x, y), cot, atol=1e-4)


@pytest.mark.parametrize("hw", [(9, 12), (10, 7)])
def test_blur_pool_autograd_matches_jax_vjp(hw):
    """Odd and even sizes: reflection sends padded 0 to 1 and n+1 to n-2."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, *hw, 4).astype(np.float32)
    ho, wo = (hw[0] - 1) // 2 + 1, (hw[1] - 1) // 2 + 1
    cot = rng.randn(2, ho, wo, 4).astype(np.float32)
    filt = binomial_filter(4, 3)
    _vjp_check(jblur.blur_pool,
               lambda a: blur_pool(a.permute(0, 3, 1, 2), filt).permute(0, 2, 3, 1),
               (x,), cot, atol=1e-5)


def test_masked_ssim_autograd_matches_jax_vjp():
    """The loss and its gradient in img1, img2 and (zero) match."""
    rng = np.random.RandomState(6)
    img1, img2 = (rng.rand(2, 20, 23, 3).astype(np.float32) for _ in range(2))
    match = rng.rand(2, 20, 23, 1).astype(np.float32)
    np.testing.assert_array_equal(gaussian_window(), jssim.gaussian_window())
    _vjp_check(jssim.masked_ssim_loss, masked_ssim_loss, (img1, img2, match),
               np.float32(1.7), atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 20, 23), (1, 7, 9), (3, 37, 70)])
def test_masked_ssim_backward_closed_form_matches_jax_vjp(shape):
    """The algebra of K10's backward in plain torch (`ssim_partials_ref`'s
    per-pixel partials a, b, c, blurred and combined by
    `masked_ssim_grad_ref`) against `jax.vjp` of the reference loss: widths
    that are not multiples of 4, an image smaller than the halo (its mask
    all below the threshold), fp32 to 1e-5 of the largest gradient."""
    b, h, w = shape
    rng = np.random.RandomState(h)
    img1, img2 = (rng.rand(b, h, w, 3).astype(np.float32) for _ in range(2))
    match = rng.rand(b, h, w, 1).astype(np.float32)
    cot = np.float32(1.7)
    _, vjp = jax.vjp(lambda a: jssim.masked_ssim_loss(a, jnp.asarray(img2), jnp.asarray(match)),
                     jnp.asarray(img1))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    abc, mask_sum = ssim_partials_ref(t(img1), t(img2), t(match))
    assert abc.shape == (9, b, h, w)
    got = masked_ssim_grad_ref(t(img1), t(img2), abc, mask_sum, float(cot)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_flow_helpers_match_jax_and_tie_gradient():
    """flow_to_grid gives gradient 0.5 at an exact tie with +-1 (jnp.clip);
    flow_gradient_magnitude keeps its 1e-24 floor (finite at d == 0)."""
    rng = np.random.RandomState(7)
    flow = (0.1 * rng.randn(1, 6, 7, 2)).astype(np.float32)
    flow[0, 0, :] = 0.0  # the identity grid's border: flow + grid == -1 exactly
    flow[0, 2:4, 2:4] = 0.0  # equal neighbours: d == 0
    grid = np.asarray(jgrid.normalized_grid(6, 7))[None]
    cot = rng.randn(1, 6, 7, 2).astype(np.float32)
    _vjp_check(lambda f: jheads.flow_to_grid(f, jnp.asarray(grid)),
               lambda f: flow_to_grid(f, t(grid)), (flow,), cot, atol=1e-7)
    f = t(flow).requires_grad_()
    flow_to_grid(f, t(grid)).sum().backward()
    assert f.grad[0, 0, 0, 1] == 0.5 and f.grad[0, 0, 0, 0] == 0.5
    cot = rng.randn(1, 5, 6, 1).astype(np.float32)
    _vjp_check(jheads.flow_gradient_magnitude, flow_gradient_magnitude, (flow,), cot,
               atol=1e-6)


def test_pair_folder_yields_the_jax_batches(tmp_path):
    """PIL's resize and the native one (tests/test_torch_native.py holds the
    resampler itself)."""
    _groups(str(tmp_path), np.random.RandomState(2), n=5)
    for use_native in (False, True):
        ours = PairFolder(str(tmp_path), img_size=32, seed=3, use_native=use_native)
        ref = _jax_train()[0].PairFolder(str(tmp_path), img_size=32, seed=3,
                                         use_native=use_native)
        assert len(ours) == len(ref) == 5 and ours.cycle == ref.cycle == 2
        for _ in range(2):  # two epochs: the generator state carries over
            got, want = list(ours.epoch_batches(2)), list(ref.epoch_batches(2))
            assert len(got) == len(want) == 2
            for a, b in zip(got, want):
                for key in ("I1", "I2"):
                    np.testing.assert_array_equal(a[key], b[key])


def test_port_imports_no_jax():
    """Every module of the port, `train`, `cli`, `eval` and the kernels
    included, without JAX, and without pandas or cv2, which the card's
    machine does not have; h5py (the YFCC calibration's reader) only inside
    the function that reads the files."""
    code = ("import sys, pkgutil, importlib, ransacflow_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, 'ransacflow_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "for name in ('cli.train', 'train.loop', 'pipeline.api', 'cli.common',\n"
            "             'cli.align', 'models.segnet', 'eval.sky', 'pipeline.bank',\n"
            "             'kernels.anchor_resample', 'kernels.adaptive_pool',\n"
            "             'eval.artifacts', 'eval.table', 'eval.compose', 'eval.hpatches',\n"
            "             'eval.kitti', 'eval.corr', 'cli.eval_hpatches', 'cli.eval_kitti',\n"
            "             'cli.eval_corr', 'eval.pose', 'eval.yfcc', 'eval.aachen',\n"
            "             'cli.eval_yfcc', 'cli.generate_pairs', 'cli.resize_dataset',\n"
            "             'pipeline.refine', 'train.validation', 'native', 'eval.pooled',\n"
            "             'utils.flops', 'ops.saliency', 'ops.ssim', 'utils.monitor',\n"
            "             'examples.synthetic_demo'):\n"
            "    assert 'ransacflow_tpu_torch.' + name in sys.modules, name\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(k.startswith('ransacflow_tpu.') for k in sys.modules)\n"
            "for name in ('pandas', 'cv2', 'h5py'):\n"
            "    assert name not in sys.modules, name + ' imported'\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_cli_trains_and_checkpoints(tmp_path):
    """`cli.train` NoVal at stage 3: 2 steps, a checkpoint that loads back."""
    data = tmp_path / "data"
    data.mkdir()
    _groups(str(data), np.random.RandomState(3), n=4)
    out = tmp_path / "out"
    cli_train.main(["--trainImgDir", str(data), "--outDir", str(out), "--stage", "3",
                    "--batchSize", "2", "--imgSize", "32", "--margin", "8",
                    "--nEpochs", "1", "--device", "cpu", "NoVal", "--epochSaveModel", "1"])
    ckpt = load_checkpoint(str(out / "checkpoint_epoch0.pt"))
    assert ckpt["step"] == 0 and set(ckpt["nets"]) == {"netFeatCoarse", "netFlowCoarse",
                                                       "netMatch"}
    assert len(ckpt["opt"]["state"]) > 0
    rec = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert rec[-1]["step"] == 0 and np.isfinite(rec[-1]["loss"]) and rec[-1]["loss_match"] > 0
    assert STAGES[3]["mode"] == "flow+match"


def _float_state(ckpt):
    """{network.name: tensor} of a checkpoint's float entries."""
    return {f"{net}.{k}": v for net, sd in ckpt["nets"].items() for k, v in sd.items()
            if v.is_floating_point()}


def _cli_train(data, out, *flags):
    cli_train.main(["--trainImgDir", str(data), "--outDir", str(out), "--stage", "3",
                    "--batchSize", "2", "--imgSize", "32", "--margin", "8", "--nEpochs", "1",
                    "--maxStepsPerEpoch", "1", "--device", "cpu", *flags, "NoVal",
                    "--epochSaveModel", "1"])
    return load_checkpoint(str(out / "checkpoint_epoch0.pt"))


@pytest.mark.parametrize("flag", [["--nDevices", "2"], ["--distributed"], ["--remat"],
                                  ["--computeDtype", "bfloat16"],
                                  ["--nativeResize", "--remat"]])
def test_cli_rejects_what_is_not_ported(tmp_path, flag):
    """--nDevices and --distributed train now (tests/test_torch_parallel.py
    runs both); what they reject is a machine that lacks what they ask for:
    --nDevices on cards beyond the machine's count raises, naming it, and
    --distributed outside a torchrun launch raises, naming the variables it
    lacks. The flags of item 14 run: a step with --remat (with
    --nativeResize too) saves the plain step's networks bit for bit; one
    with --computeDtype bfloat16 saves fp32 masters, BatchNorm statistics
    and Adam state."""
    base = ["--trainImgDir", str(tmp_path), "--outDir", str(tmp_path)]
    if flag[0] == "--nDevices":
        have = torch.cuda.device_count()
        n = max(have + 1, 2)
        with pytest.raises(RuntimeError, match=f"a mesh of {n} cuda devices: "
                                               f"this machine has {have}"):
            cli_train.main([*base, "--device", "cuda", "--nDevices", str(n), "NoVal"])
        return
    if flag[0] == "--distributed":
        env = {v: os.environ.pop(v) for v in ("RANK", "WORLD_SIZE") if v in os.environ}
        try:
            with pytest.raises(RuntimeError, match="no torchrun environment: RANK, WORLD_SIZE"):
                cli_train.main([*base, "--device", "cpu", *flag, "NoVal"])
        finally:
            os.environ.update(env)
        return
    data = tmp_path / "data"
    data.mkdir()
    _groups(str(data), np.random.RandomState(3), n=2)
    ckpt = _cli_train(data, tmp_path / "run", *flag)
    state = _float_state(ckpt)
    assert all(v.dtype == torch.float32 for v in state.values())
    assert all(v.dtype == torch.float32 for st in ckpt["opt"]["state"].values()
               for v in st.values() if v.is_floating_point())
    if "--remat" in flag:
        plain = _float_state(_cli_train(data, tmp_path / "plain",
                                        *[f for f in flag if f != "--remat"]))
        for k, v in plain.items():
            assert torch.equal(state[k], v), k


def test_fit_rejects_what_is_not_ported(tmp_path):
    """fit(n_devices=2) outside a process group of 2 ranks raises, naming
    what it needs (tests/test_torch_parallel.py runs it in one). remat=True
    and compute_dtype='bfloat16' train: remat gives the plain fit's losses,
    weights and BatchNorm statistics bit for bit (the same ops on the CPU),
    bf16 keeps every master and statistic fp32 and its losses finite."""
    with pytest.raises(ValueError, match="n_devices=2 trains one process a device"):
        fit({}, str(tmp_path), str(tmp_path), "cpu", n_devices=2)
    data = tmp_path / "data"
    data.mkdir()
    _groups(str(data), np.random.RandomState(4), n=4)
    kw = dict(mode="flow+match", mu_cycle=1.0, lambda_match=0.01, epochs=1, batch_size=B,
              img_size=IMG, margin=MARGIN, kernel_size=K, seed=0, log_every=1,
              max_steps_per_epoch=2)
    runs = {}
    for name, extra in (("plain", {}), ("remat", dict(remat=True)),
                        ("bf16", dict(compute_dtype="bfloat16"))):
        nets = init_alignment_params(torch.Generator().manual_seed(0), "cpu", K)
        fit(nets, str(data), str(tmp_path / name), "cpu", **kw, **extra)
        recs = [{k: v for k, v in json.loads(line).items() if k != "time"}
                for line in open(tmp_path / name / "metrics.jsonl")]
        runs[name] = (recs, {f"{n}.{k}": v for n, net in nets.items()
                             for k, v in net.state_dict().items()})
    assert runs["remat"][0] == runs["plain"][0]
    for k, v in runs["plain"][1].items():
        assert torch.equal(runs["remat"][1][k], v), k
    recs, state = runs["bf16"]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert all(v.dtype == runs["plain"][1][k].dtype for k, v in state.items())
    assert recs[-1]["loss"] != runs["plain"][0][-1]["loss"]  # bf16 convolutions ran


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(setup, monkeypatch):
    """One stage-3 step through the kernels against the port on the CPU. End
    to end: the losses and the BN running statistics. The gradients with the
    correlation volume pinned to one value on both devices, as in the JAX
    comparison (`_shared_corr` says why), by two measures: the median over
    tensors of each tensor's max difference over its largest magnitude to
    1e-4, and each tensor's cosine similarity to >= 0.999. Not each tensor
    to 1e-4: the gradients are piecewise smooth (ReLU and max-pool kinks,
    grid_sample's pixel edges), cuDNN and the kernels sum in other orders
    (K11 with atomics, in a run-to-run order), and at these shapes a 3e-7
    change of the images alone moved one tensor by up to 5.4% of its
    largest magnitude in a third of the trials (cosine >= 0.99993) while
    the median stayed near 1.5e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ransacflow_tpu_torch.train import losses

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    trees, imgs = setup
    corr = torch.from_numpy(_shared_corr(trees, imgs))
    orig = losses.correlation_volume

    def pinned(x, y, k):
        c = orig(x, y, k)
        return corr.to(c.device) + (c - c.detach())

    res = {}
    for device in ("cpu", "cuda"):
        nets = alignment_params_from_tree(trees, device)
        opt = make_optimizer(split_trainable(nets, "flow+match")[0])
        metrics = train_step(nets, opt, *_torch_batch(imgs, device), mode="flow+match",
                             **LOSS_KW)
        stats = {f"{n}.{k}": b.cpu() for n, net in nets.items()
                 for k, b in net.named_buffers()}
        nets = alignment_params_from_tree(trees, device)
        monkeypatch.setattr(losses, "correlation_volume", pinned)
        train_step(nets, make_optimizer(split_trainable(nets, "flow+match")[0]),
                   *_torch_batch(imgs, device), mode="flow+match", **LOSS_KW)
        monkeypatch.undo()
        res[device] = ({k: float(v) for k, v in metrics.items()}, stats,
                       {f"{n}.{k}": p.grad.cpu() for n, net in nets.items()
                        for k, p in net.named_parameters() if p.grad is not None})
    for k, v in res["cpu"][0].items():
        np.testing.assert_allclose(res["cuda"][0][k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    for k, v in res["cpu"][1].items():
        torch.testing.assert_close(res["cuda"][1][k], v, rtol=1e-4, atol=1e-5, msg=k)
    assert res["cpu"][2].keys() == res["cuda"][2].keys() and res["cpu"][2]
    of_max, cosine = {}, {}
    for k, v in res["cpu"][2].items():
        got = res["cuda"][2][k]
        of_max[k] = float((got - v).abs().max() / v.abs().max())
        cosine[k] = float(torch.nn.functional.cosine_similarity(got.flatten(), v.flatten(),
                                                                dim=0))
    worst = sorted(of_max.items(), key=lambda kv: kv[1])[-3:]
    assert min(cosine.values()) >= 0.999, (min(cosine.items(), key=lambda kv: kv[1]), worst)
    assert np.median(list(of_max.values())) <= 1e-4, worst
