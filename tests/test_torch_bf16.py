"""The bf16 compute policies of the port (`models/layers.cast_params`, the
eval policy behind `cli/common.cast_for_dtype`; `cast_compute_params`, the
training policy behind `fit(compute_dtype=...)`) and `remat`, on the CPU,
against the JAX package's.

Tolerances:
- BF16_ULPS: the trunks and heads of both packages under the eval policy,
  the largest difference in units of the bf16 spacing at the tensor's
  largest magnitude (2^(floor(log2 max|ref|) - 7)). The two packages round
  in other places (JAX's eval BatchNorm rounds after each of its four
  elementwise ops, PyTorch's once), so a few such units after ~50 layers.
- The serving path and the device loop in bf16 against fp32: JAX's own
  tests' tolerances (tests/test_fused.py:60-90, atol 0.05 on the normalized
  H; tests/test_pipeline.py:351-385, 0.02 against the planted H and 0.01
  against fp32's by the mean point error).
- Training: step 0's loss within 5e-3 of fp32's (tests/test_train.py:246-
  272); remat against the plain step: loss rtol 1e-6, parameters and
  BatchNorm statistics rtol 2e-5 / atol 2e-6 (tests/test_train.py:91-110).
"""

import argparse
import copy
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransacflow_tpu.models import cast_params as j_cast
from ransacflow_tpu.models import feature_extractor as j_feature_extractor
from ransacflow_tpu.models import init_resnet50_layer3 as j_init_resnet
from ransacflow_tpu.models import resnet50_layer3 as j_resnet50_layer3
from ransacflow_tpu.models.heads import net_flow_coarse as j_net_flow_coarse
from ransacflow_tpu.models.heads import net_matchability as j_net_matchability
from ransacflow_tpu.pipeline import init_alignment_params as j_init_align
from ransacflow_tpu_torch.cli.common import add_compute_dtype_flag, cast_for_dtype
from ransacflow_tpu_torch.kernels.matching import mutual_argmax
from ransacflow_tpu_torch.models import convert
from ransacflow_tpu_torch.models.feature_extractor import feature_extractor
from ransacflow_tpu_torch.models.heads import net_flow_coarse, net_matchability
from ransacflow_tpu_torch.models.layers import cast_params
from ransacflow_tpu_torch.models.resnet50 import resnet50_layer3
from ransacflow_tpu_torch.ops.grid import normalized_grid
from ransacflow_tpu_torch.ops.homography import warp_grid
from ransacflow_tpu_torch.ops.sampler import grid_sample
from ransacflow_tpu_torch.pipeline import CoarseAligner, fused, multi_homography_predict_fused
from ransacflow_tpu_torch.train import (
    local_index_roll,
    make_optimizer,
    margin_mask,
    split_trainable,
    train_step,
)

BF16 = torch.bfloat16
BF16_ULPS = 4
IMG, MARGIN, B, K = 32, 8, 2, 7
LOSS_KW = dict(mode="flow+match", mu_cycle=1.0, lambda_match=0.01, grad_weight=1.0,
               kernel_size=K)


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


def _ulps_off(ours, ref):
    """max |ours - ref| in bf16 spacings at max |ref|."""
    ours = ours.float().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref, np.float32)
    spacing = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    return float(np.abs(ours - ref).max() / spacing)


def test_trunks_and_heads_match_jax_bf16(rng, nets):
    """The eval policy in both packages: every parameter and buffer bf16,
    bf16 outputs, within BF16_ULPS of each other; the port's caller keeps
    its fp32 networks."""
    jr, ja, resnet, align = nets
    x = rng.rand(1, 64, 96, 3).astype(np.float32)
    r16 = cast_for_dtype(resnet, "bfloat16")
    a16 = cast_for_dtype(align, "bfloat16")
    assert next(resnet.parameters()).dtype == torch.float32
    for net in (r16, *a16.values()):
        assert {t.dtype for t in net.state_dict().values() if t.is_floating_point()} == {BF16}
    with torch.no_grad():
        ours = resnet50_layer3(r16, torch.from_numpy(x))
        feats = feature_extractor(a16["netFeatCoarse"], torch.from_numpy(x))
    ref, _ = j_resnet50_layer3(j_cast(jr, jnp.bfloat16), jnp.asarray(x))
    assert ours.dtype == BF16 and ref.dtype == jnp.bfloat16
    assert _ulps_off(ours, ref) <= BF16_ULPS
    ref_f, _ = j_feature_extractor(j_cast(ja["netFeatCoarse"], jnp.bfloat16), jnp.asarray(x))
    assert feats.dtype == BF16 and _ulps_off(feats, ref_f) <= BF16_ULPS

    corr = (rng.randn(1, 8, 12, K * K) * 0.3).astype(np.float32)
    with torch.no_grad():
        flow = net_flow_coarse(a16["netFlowCoarse"], torch.from_numpy(corr), False, K)
        match = net_matchability(a16["netMatch"], torch.from_numpy(corr), False)
    flow_r, _ = j_net_flow_coarse(j_cast(ja["netFlowCoarse"], jnp.bfloat16), jnp.asarray(corr),
                                  up8=False, kernel_size=K)
    match_r, _ = j_net_matchability(j_cast(ja["netMatch"], jnp.bfloat16), jnp.asarray(corr),
                                    up8=False)
    assert flow.dtype == match.dtype == BF16 and flow_r.dtype == match_r.dtype == jnp.bfloat16
    assert _ulps_off(flow, flow_r) <= BF16_ULPS
    assert _ulps_off(match, match_r) <= BF16_ULPS


def test_fused_align_bf16_consistent_with_fp32(rng, nets):
    """tests/test_fused.py:60-90 in the port: the same homography as fp32 on
    a clearly matchable pair; the convolutions and the matching GEMM run in
    bf16, the geometry in fp32."""
    _, _, resnet, align = nets
    h = w = 128
    base = (rng.rand(h // 4, w // 4, 3) > 0.5).astype(np.float32)
    src = torch.from_numpy(np.kron(base, np.ones((4, 4, 1), np.float32))[:h, :w])
    H_true = torch.tensor([[1, 0, 0.25], [0, 1, 0.25], [0, 0, 1]])
    tgt = grid_sample(src[None], warp_grid(H_true[None], h, w)).contiguous()

    def run(r, a):
        return fused.fused_align(r, a, (src[None],), tgt, torch.Generator().manual_seed(0),
                                 n_iter=2000)

    out32 = run(resnet, align)
    out16 = run(cast_for_dtype(resnet, "bfloat16"), cast_for_dtype(align, "bfloat16"))
    h32 = out32["H21"].double().numpy()
    h16 = out16["H21"].double().numpy()
    np.testing.assert_allclose(h16 / h16[2, 2], h32 / h32[2, 2], atol=0.05)
    assert int(out16["num_inliers"]) > 0
    assert out16["H21"].dtype == out16["flow"].dtype == torch.float32
    assert out16["flow_down8"].dtype == BF16  # the heads' dtype, as JAX's


def _translated_pair(rng, size=256, dx_px=32, dy_px=16):
    from PIL import Image

    base = (rng.rand(size // 4, size // 4, 3) > 0.5).astype(np.float32)
    src_arr = np.kron(base, np.ones((4, 4, 1), np.float32))
    H_true = np.array([[1, 0, 2 * dx_px / size], [0, 1, 2 * dy_px / size], [0, 0, 1]],
                      np.float32)
    g = warp_grid(torch.from_numpy(H_true)[None], size, size)
    tgt_arr = grid_sample(torch.from_numpy(src_arr)[None], g)[0].numpy()
    to_pil = lambda a: Image.fromarray((np.clip(a, 0, 1) * 255).astype(np.uint8))  # noqa: E731
    return to_pil(src_arr), to_pil(tgt_arr), H_true


def _h_error(h_est, h_true, n=64):
    """Mean distance of 64 points mapped by the two homographies."""
    pts = np.random.RandomState(0).rand(n, 2) * 1.2 - 0.6
    homog = np.concatenate([pts, np.ones((n, 1))], axis=1)

    def apply(h):
        q = homog @ np.asarray(h, np.float64).T
        return q[:, :2] / q[:, 2:]

    return np.abs(apply(h_est) - apply(h_true)).mean()


def test_device_loop_bf16_consistent_with_fp32(rng, nets):
    """tests/test_pipeline.py:351-385 in the port: the device-resident loop
    under bf16 networks recovers the planted translation and fp32's first
    homography; the fine outputs come back finite (fp32 artifacts of bf16
    values)."""
    _, _, resnet, align = nets
    src, tgt, H_true = _translated_pair(rng)
    border = np.ones((256, 256), np.float32)
    border[48:-48, 48:-48] = 0

    def run(r, a):
        coarse = CoarseAligner(r, "cpu", nb_scale=1, n_iter=2000, min_size=256,
                               polish_fp64=False)
        coarse.set_pair(src, tgt)
        coarse.reseed(0)
        return multi_homography_predict_fused(coarse, a, max_coarse=2, mask_region_th=0.01,
                                              bg_mask=1.0 - border)

    out32 = run(resnet, align)
    out16 = run(cast_for_dtype(resnet, "bfloat16"), cast_for_dtype(align, "bfloat16"))
    assert out32 is not None and out16 is not None
    assert _h_error(out16["coarse_h"][0], H_true) < 0.02
    assert _h_error(out16["coarse_h"][0], out32["coarse_h"][0]) < 0.01
    assert out16["fine_flow_down8"].dtype == np.float32
    assert np.isfinite(out16["fine_flow_down8"]).all()


def test_mutual_argmax_on_a_bf16_score_keeps_the_tie_rules(rng):
    """K2 handed a bf16 score (many ties) gives the fp32 upcast's answer
    exactly, exact and relaxed: the first index wins each tie."""
    score = torch.from_numpy(rng.randint(-4, 5, (300, 48)).astype(np.float32) / 8).to(BF16)
    for relax in (0, 1):
        got = mutual_argmax(score, relax, 8)
        want = mutual_argmax(score.float(), relax, 8)
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a, b)
        assert got[3].dtype == BF16 and torch.equal(got[3].float(), want[3])


# -- the dtype at each kernel's boundary -------------------------------------

# (kernel, caller module, wrapper name): where each path calls the wrappers
_BOUNDARIES = (
    ("K2 mutual_argmax", "ransacflow_tpu_torch.ops.matching", "mutual_argmax"),
    ("K3 ransac", "ransacflow_tpu_torch.ops.ransac", "ransac_fit"),
    ("K5h warp_homography", "ransacflow_tpu_torch.pipeline.fine", "warp_homography"),
    ("K6 correlation_pair", "ransacflow_tpu_torch.pipeline.fine", "correlation_pair"),
    ("K7 head_epilogues", "ransacflow_tpu_torch.pipeline.fine", "head_epilogues"),
    ("K8 compose_tail", "ransacflow_tpu_torch.pipeline.fine", "compose_tail"),
    ("K9 blur_pool", "ransacflow_tpu_torch.ops.blurpool", "blur_pool"),
    ("K12 anchor_resample", "ransacflow_tpu_torch.pipeline.bank", "anchor_resample_bank"),
    ("K5 warp_sample", "ransacflow_tpu_torch.train.losses", "grid_sample"),
    ("K6 correlation_volume", "ransacflow_tpu_torch.train.losses", "correlation_volume"),
    ("K7 flow_epilogue", "ransacflow_tpu_torch.models.heads", "flow_epilogue"),
    ("K7 match_epilogue", "ransacflow_tpu_torch.models.heads", "match_epilogue"),
    ("K10 masked_ssim", "ransacflow_tpu_torch.train.losses", "masked_ssim_loss"),
)
F32, B16 = "float32", "bfloat16"
# The table of PERF.md ("The dtype at each kernel's boundary"): the tensor
# inputs of each wrapper on the path, as JAX hands them to its op.
EVAL_BF16 = {
    "K2 mutual_argmax": (F32,),           # the bf16 GEMM's fp32 score
    "K3 ransac": (F32, F32, "bool"),      # the matches' coordinates, valid
    "K5h warp_homography": (F32, F32),    # the image, H
    "K6 correlation_pair": (B16, B16),
    "K7 head_epilogues": (B16, B16, B16),
    "K8 compose_tail": (B16, B16, B16, F32),  # flow, match12, match21, coarse grid
    "K9 blur_pool": (B16, B16),           # activations, filter
    "K12 anchor_resample": (B16,),        # an anchor's trunk map
}
TRAIN_BF16 = {
    "K5 warp_sample": (F32, F32),
    "K6 correlation_volume": (F32, F32),
    "K7 flow_epilogue": (B16,),
    "K7 match_epilogue": (B16,),
    "K9 blur_pool": (F32, F32),
    "K10 masked_ssim": (F32, F32, F32),
}


def _spy(monkeypatch, seen, grads):
    """Record the dtypes of the tensors each wrapper gets (first call), and
    of the cotangents that reach its inputs that require grad."""
    for key, module, name in _BOUNDARIES:
        mod = importlib.import_module(module)
        fn = getattr(mod, name)

        def wrapped(*args, _key=key, _fn=fn, **kwargs):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            if _key == "K12 anchor_resample":
                tensors = [args[0][args[2][0]]]
            seen.setdefault(_key, tuple(str(t.dtype).removeprefix("torch.")
                                        for t in tensors))
            for i, t in enumerate(tensors):
                if t.requires_grad and torch.is_grad_enabled():
                    def hook(g, _t=t, _i=i, _key=_key):
                        grads.setdefault((_key, _i), (_t.dtype, g.dtype))
                    t.register_hook(hook)
            return _fn(*args, **kwargs)

        monkeypatch.setattr(mod, name, wrapped)


def test_dtype_at_each_kernel_boundary(rng, nets, monkeypatch):
    """Under the eval policy (a serving pair in the exact and the anchor
    mode) and the training policy (a stage-3 step), each kernel wrapper gets
    the dtypes of PERF.md's table, and every cotangent comes back in its
    input's dtype."""
    _, _, resnet, align = nets
    seen, grads = {}, {}
    _spy(monkeypatch, seen, grads)
    r16, a16 = cast_for_dtype(resnet, "bfloat16"), cast_for_dtype(align, "bfloat16")
    pyramid = tuple(torch.from_numpy(rng.rand(1, s, s, 3).astype(np.float32))
                    for s in (96, 64, 48))
    target = torch.from_numpy(rng.rand(1, 64, 64, 3).astype(np.float32))
    for mode in ({}, dict(anchor_stride=2)):
        fused.fused_align(r16, a16, pyramid, target, torch.Generator().manual_seed(0),
                          n_iter=64, **mode)
    assert seen == EVAL_BF16

    seen.clear()
    imgs = torch.from_numpy(rng.rand(2 * B, IMG, IMG, 3).astype(np.float32))
    trained = copy.deepcopy(align)
    opt = make_optimizer(split_trainable(trained, "flow+match")[0])
    train_step(trained, opt, imgs, local_index_roll(B, "cpu"),
               normalized_grid(IMG, IMG, "cpu")[None], margin_mask(2 * B, IMG, MARGIN, "cpu"),
               compute_dtype="bfloat16", **LOSS_KW)
    assert {k: v for k, v in seen.items() if k in TRAIN_BF16} == TRAIN_BF16
    assert grads and all(t == g for t, g in grads.values()), grads
    assert {k for k, _ in grads} >= {"K6 correlation_volume", "K7 flow_epilogue",
                                     "K7 match_epilogue", "K5 warp_sample"}


# -- the training policy and remat -------------------------------------------


def _steps(align, imgs, n, **kw):
    nets = copy.deepcopy(align)
    opt = make_optimizer(split_trainable(nets, "flow+match")[0], lr=1e-3)
    batch = (imgs, local_index_roll(B, "cpu"), normalized_grid(IMG, IMG, "cpu")[None],
             margin_mask(2 * B, IMG, MARGIN, "cpu"))
    losses = [float(train_step(nets, opt, *batch, **LOSS_KW, **kw)["loss"])
              for _ in range(n)]
    return losses, nets, opt


def test_training_policy_keeps_fp32_masters(rng, nets):
    """tests/test_train.py:246-272 in the port: 10 steps under the bf16
    policy keep every master weight, BatchNorm statistic and Adam moment in
    fp32; step 0's loss is within 5e-3 of fp32's and of the JAX package's
    bf16 step 0; the loss falls."""
    from ransacflow_tpu.train import losses as jlosses
    from ransacflow_tpu.train import trainer as jtrainer

    _, ja, _, align = nets
    imgs = rng.rand(2 * B, IMG, IMG, 3).astype(np.float32)
    l32, _, _ = _steps(align, torch.from_numpy(imgs), 1)
    l16, nets16, opt16 = _steps(align, torch.from_numpy(imgs), 10, compute_dtype="bfloat16")
    for net in nets16.values():
        assert {t.dtype for t in net.state_dict().values() if t.is_floating_point()} == \
            {torch.float32}
        assert all(m.compute_dtype is None for m in net.modules()
                   if hasattr(m, "compute_dtype"))  # the policy ends with the step
    assert {v.dtype for st in opt16.state.values() for v in st.values()
            if v.is_floating_point()} == {torch.float32}
    assert all(np.isfinite(l16))
    assert abs(l16[0] - l32[0]) < 5e-3
    assert np.mean(l16[6:]) < np.mean(l16[:2])
    loss_j = jax.jit(lambda p, x: jlosses.compute_losses(
        p, x, jtrainer.local_index_roll(B),
        jnp.asarray(normalized_grid(IMG, IMG, "cpu").numpy())[None],
        jlosses.margin_mask(2 * B, IMG, MARGIN), train=True, compute_dtype=jnp.bfloat16,
        **LOSS_KW)[0])(ja, jnp.asarray(imgs))
    assert abs(l16[0] - float(loss_j)) < 5e-3


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"], ids=["fp32", "bf16"])
def test_remat_matches_plain(rng, nets, compute_dtype):
    """tests/test_train.py:91-110 in the port: two steps with the trunk
    recomputed in the backward give the plain steps' losses, weights and
    BatchNorm statistics (the recompute must not move them again), and the
    batch count once a step."""
    _, _, _, align = nets
    imgs = torch.from_numpy(rng.rand(2 * B, IMG, IMG, 3).astype(np.float32))
    l0, n0, _ = _steps(align, imgs, 2, compute_dtype=compute_dtype)
    l1, n1, _ = _steps(align, imgs, 2, compute_dtype=compute_dtype, remat=True)
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    for name in n0:
        s0, s1 = n0[name].state_dict(), n1[name].state_dict()
        for key, v in s0.items():
            if v.is_floating_point():
                np.testing.assert_allclose(s1[key].numpy(), v.numpy(), rtol=2e-5, atol=2e-6,
                                           err_msg=f"{name}.{key}")
            else:
                assert torch.equal(s1[key], v), f"{name}.{key}"
    moved = [k for k, v in n0["netFeatCoarse"].state_dict().items()
             if "running_mean" in k and not torch.equal(v, align["netFeatCoarse"]
                                                        .state_dict()[k])]
    assert moved  # the statistics moved, once
    assert int(n1["netFeatCoarse"].bn1.num_batches_tracked) == 2


def test_eval_compute_dtype_policy():
    """tests/test_cli.py:102 in the port: float32 is the default of every
    eval CLI's --computeDtype, each wires it through `cast_for_dtype` on
    predict, and `cast_for_dtype` casts a network or a dict of them, leaves
    None and float32 alone."""
    p = argparse.ArgumentParser()
    add_compute_dtype_flag(p)
    assert p.parse_args([]).computeDtype == "float32"
    assert p.parse_args(["--computeDtype", "bfloat16"]).computeDtype == "bfloat16"
    for cli in ("eval_hpatches", "eval_corr", "eval_kitti", "eval_yfcc"):
        src = inspect.getsource(importlib.import_module(f"ransacflow_tpu_torch.cli.{cli}"))
        assert "add_compute_dtype_flag" in src, cli
        assert "cast_for_dtype(load_coarse_net(" in src, cli
        assert "cast_for_dtype(load_align_params(" in src, cli

    net = torch.nn.Sequential(torch.nn.Conv2d(1, 1, 1), torch.nn.BatchNorm2d(1))
    assert cast_for_dtype(net, "float32") is net
    assert cast_for_dtype(None, "bfloat16") is None
    cast = cast_for_dtype(net, "bfloat16")
    assert cast is not net and net[0].weight.dtype == torch.float32
    assert {t.dtype for t in cast.state_dict().values() if t.is_floating_point()} == {BF16}
    nets = cast_for_dtype({"a": net}, "bfloat16")
    assert nets["a"][1].running_var.dtype == BF16
    assert cast_params(net, BF16)[0].weight.dtype == BF16
