"""The frozen trunk's BatchNorm folded into its convolutions, and kernel 14
(`kernels/conv_epilogue`), the one pass that ends each folded convolution.

On the CPU: the fold's algebra, the folded forward of `Bottleneck`,
`ResNet50Layer3` and the sky network's encoder against the unfolded one,
the trunk against JAX, the unfolded paths (grad, train mode, the bf16 eval
policy) bit for bit the forward the modules had before the fold, the folded
state's life (made anew after `load_state_dict`, an in-place edit, `.to()`,
a deep copy, never in `state_dict`), the plain version of kernel 14, and its
40 calls a trunk pass. The `gpu` tests hold the kernel to its plain version
and the folded trunk to the unfolded one on the card. JAX is imported inside
the one test that compares with it, so that this file collects where the
card is.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ransacflow_tpu_torch import kernels
from ransacflow_tpu_torch.kernels.conv_epilogue import conv_epilogue, conv_epilogue_ref
from ransacflow_tpu_torch.models import layers, resnet50
from ransacflow_tpu_torch.models.convert import init_resnet50_layer3, init_segnet
from ransacflow_tpu_torch.models.layers import cast_params, fold_bn, nchw, nhwc
from ransacflow_tpu_torch.models.resnet50 import Bottleneck, resnet50_layer3
from ransacflow_tpu_torch.models.segnet import segnet_encoder
from ransacflow_tpu_torch.parallel.mesh import replicate

FOLD_RTOL = 1e-5  # of the largest magnitude: the fold's rounding moves ~1e-6


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


def _perturb_bn(net, seed):
    """Every BatchNorm's statistics and affine moved off the identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.75 + 0.5 * torch.rand(c, generator=g))
                m.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
    return net


def _block(cin, planes, stride, dilation=1, seed=0):
    b = Bottleneck(cin, planes, stride, dilation)
    for m in b.modules():
        if isinstance(m, torch.nn.Conv2d):
            layers.kaiming_normal_(m, torch.Generator().manual_seed(seed + m.out_channels))
    return _perturb_bn(b, seed).eval()


def _trunk(seed=0):
    return _perturb_bn(init_resnet50_layer3(torch.Generator().manual_seed(seed), "cpu"), seed)


# the forward the modules had before the fold, written out
def _seed_bottleneck(b, x):
    out = F.relu(b.bn1(b.conv1(x)))
    out = F.relu(b.bn2(b.conv2(out)))
    out = b.bn3(b.conv3(out))
    res = x if b.downsample is None else b.downsample(x)
    return F.relu(out + res)


def _seed_trunk(net, x):
    x = F.relu(net.bn1(net.conv1(x)))
    x = F.max_pool2d(x, 3, 2, 1)
    for layer in (net.layer1, net.layer2, net.layer3):
        for b in layer:
            x = _seed_bottleneck(b, x)
    return x


def _unfolded(fn):
    """fn() with grad on: the modules take their unfolded forward."""
    with torch.enable_grad():
        return fn().detach()


def _folded(fn):
    with torch.no_grad():
        return fn()


def _close(got, want, rtol=FOLD_RTOL):
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= rtol * scale, f"max abs err {err} against a largest {scale}"


@pytest.mark.parametrize("cin,cout,k,stride,padding,dilation",
                         [(16, 24, 1, 1, 0, 1), (8, 12, 3, 2, 1, 1), (8, 8, 3, 1, 2, 2),
                          (3, 16, 7, 2, 3, 1)])
def test_fold_bn_is_the_eval_batch_norm(cin, cout, k, stride, padding, dilation):
    """conv + bias with the folded weight and bias against conv -> eval-mode
    `BatchNorm2d`, on random statistics."""
    g = torch.Generator().manual_seed(k + cin)
    c = layers.conv(cin, cout, k, stride, padding, dilation)
    bn = _perturb_bn(layers.BatchNorm2d(cout), k).eval()
    layers.kaiming_normal_(c, g)
    x = torch.randn(2, cin, 19, 23, generator=g)
    w, b = fold_bn(c, bn)
    assert w.dtype == torch.float32 and w.is_contiguous() and b.dtype == torch.float64
    with torch.no_grad():
        want = bn(c(x))
        got = F.conv2d(x, w, b.float(), stride, padding, dilation)
    _close(got, want)


@pytest.mark.parametrize("case", ["identity", "downsample", "stride2", "dilated"])
def test_folded_bottleneck_matches_unfolded(rng, case):
    """`Bottleneck` frozen (folded, kernel 14's plain version on the CPU)
    against its unfolded forward: the identity shortcut, a downsample at
    stride 1 and 2, a dilated conv2 (the sky network's)."""
    cin, planes, stride, dilation = {"identity": (64, 16, 1, 1), "downsample": (32, 16, 1, 1),
                                     "stride2": (64, 16, 2, 1), "dilated": (64, 16, 1, 2)}[case]
    b = _block(cin, planes, stride, dilation)
    assert (b.downsample is None) == (case in ("identity", "dilated"))
    x = torch.from_numpy(rng.rand(2, cin, 13, 18).astype(np.float32))
    got = _folded(lambda: b(x))
    assert b._fold is not None and got.is_contiguous()
    _close(got, _unfolded(lambda: b(x)))
    # a channels-last input (the sky network's stem hands one) folds the same
    _close(_folded(lambda: b(x.contiguous(memory_format=torch.channels_last))), got)


@pytest.mark.parametrize("net", ["trunk", "segnet"])
def test_folded_networks_match_unfolded(rng, net):
    """The trunk (stem and 13 blocks) and the sky network's dilated
    encoder, frozen, against their unfolded forward."""
    if net == "trunk":
        module, fn = _trunk(), resnet50_layer3
        x = torch.from_numpy(rng.rand(2, 64, 80, 3).astype(np.float32))
    else:
        module, fn = _perturb_bn(init_segnet(torch.Generator().manual_seed(3), "cpu")[0], 3), \
            segnet_encoder
        x = torch.from_numpy(rng.rand(1, 40, 48, 3).astype(np.float32))
    with torch.inference_mode():  # the serving path's mode folds outside it
        got = fn(module, x)
    folds = [m._fold for m in module.modules() if isinstance(m, layers.FrozenBNFold)]
    assert folds and all(f is not None and not f[0].is_inference() for f in folds)
    assert got.is_contiguous()
    _close(got, _unfolded(lambda: fn(module, x)))
    torch.testing.assert_close(_folded(lambda: fn(module, x)), got, rtol=0, atol=0)


def test_folded_trunk_matches_jax(rng):
    """The JAX parity of `tests/test_torch_models.py` (5e-4) on the frozen
    trunk, BatchNorm statistics perturbed."""
    import jax.numpy as jnp
    from jax import random

    from ransacflow_tpu.models import resnet50 as jresnet
    from ransacflow_tpu_torch.models.convert import resnet50_layer3_from_tree

    brng = np.random.RandomState(5)

    def perturbed(tree):
        out = {k: perturbed(v) if isinstance(v, dict) else np.asarray(v, np.float32)
               for k, v in tree.items()}
        if "running_mean" in out:
            c = out["running_mean"].shape[0]
            out["running_mean"] = (0.1 * brng.randn(c)).astype(np.float32)
            out["running_var"] = (0.75 + 0.5 * brng.rand(c)).astype(np.float32)
            out["weight"] = (1 + 0.1 * brng.randn(c)).astype(np.float32)
            out["bias"] = (0.1 * brng.randn(c)).astype(np.float32)
        return out

    tree = perturbed(jresnet.init_resnet50_layer3(random.PRNGKey(0)))
    net = resnet50_layer3_from_tree(tree, "cpu")
    xin = jresnet.imagenet_preprocess(jnp.asarray(rng.rand(1, 64, 80, 3).astype(np.float32)))
    ref, _ = jresnet.resnet50_layer3(tree, xin)
    ours = _folded(lambda: resnet50_layer3(net, torch.from_numpy(np.array(xin))))
    assert net._fold is not None
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=5e-4)


@pytest.mark.parametrize("path", ["grad", "train", "bf16"])
def test_unfolded_paths_bit_for_bit(rng, path):
    """Under grad (an input that requires it), in train mode and under the
    bf16 eval policy the trunk runs the forward it had before the fold, bit
    for bit, and folds nothing."""
    net = _trunk()
    x = torch.from_numpy(rng.rand(2, 48, 64, 3).astype(np.float32))
    if path == "grad":
        x.requires_grad_()
        got = resnet50_layer3(net, x)
        want = nhwc(_seed_trunk(net, nchw(x)))
        got.sum().backward()  # the graph is whole
        assert x.grad is not None
    elif path == "train":
        a, b = copy.deepcopy(net).train(), copy.deepcopy(net).train()
        with torch.no_grad():
            got, want = resnet50_layer3(a, x), nhwc(_seed_trunk(b, nchw(x)))
        for (ka, va), (_, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(va, vb), ka  # the running statistics moved alike
        net = a
    else:
        net = cast_params(net, "bfloat16")
        xb = x.bfloat16()
        with torch.no_grad():
            got, want = resnet50_layer3(net, xb), nhwc(_seed_trunk(net, nchw(xb)))
        assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert all(m._fold is None for m in net.modules() if isinstance(m, layers.FrozenBNFold))


def test_fold_made_anew_after_load_state_dict_and_an_edit(rng):
    b = _block(32, 16, 2)
    x = torch.from_numpy(rng.rand(1, 32, 11, 14).astype(np.float32))
    first = _folded(lambda: b(x)).clone()
    fold = b._fold
    assert _folded(lambda: b(x)) is not None and b._fold is fold  # kept while unchanged
    b.load_state_dict(_block(32, 16, 2, seed=9).state_dict())
    got = _folded(lambda: b(x))
    assert b._fold is not fold
    _close(got, _unfolded(lambda: b(x)))
    assert not torch.allclose(got, first)
    for edit in (lambda: b.conv2.weight.mul_(1.5), lambda: b.bn3.running_var.add_(0.5),
                 lambda: b.downsample[1].bias.sub_(0.25)):
        fold = b._fold
        with torch.no_grad():
            edit()
        got = _folded(lambda: b(x))
        assert b._fold is not fold
        _close(got, _unfolded(lambda: b(x)))


def test_fold_follows_to_deepcopy_and_replicas(rng):
    net = _trunk()
    x = torch.from_numpy(rng.rand(1, 48, 64, 3).astype(np.float32))
    want = _folded(lambda: resnet50_layer3(net, x))
    # a deep copy carries its own sources: an edit of the copy leaves the original
    twin = copy.deepcopy(net)
    torch.testing.assert_close(_folded(lambda: resnet50_layer3(twin, x)), want, rtol=0, atol=0)
    with torch.no_grad():
        twin.layer1[0].conv1.weight.mul_(2.0)
    _close(_folded(lambda: resnet50_layer3(twin, x)), _unfolded(lambda: resnet50_layer3(twin, x)))
    torch.testing.assert_close(_folded(lambda: resnet50_layer3(net, x)), want, rtol=0, atol=0)
    # a move drops the fold; fp64 runs unfolded, back in fp32 it folds anew
    old = net.layer2[1]._fold
    net.to(torch.float64)
    assert net.layer2[1]._fold is None
    got64 = _folded(lambda: resnet50_layer3(net, x.double()))
    assert got64.dtype == torch.float64 and net.layer2[1]._fold is None
    net.to(torch.float32)
    torch.testing.assert_close(_folded(lambda: resnet50_layer3(net, x)), want, rtol=0, atol=0)
    assert net.layer2[1]._fold is not None and net.layer2[1]._fold is not old
    # the mesh's replicas fold their own copies
    for replica in replicate(net, ["cpu", "cpu"]):
        torch.testing.assert_close(_folded(lambda: resnet50_layer3(replica, x)), want,
                                   rtol=0, atol=0)


def test_state_dict_keys_unchanged(rng):
    net = _trunk()
    keys = list(net.state_dict())
    _folded(lambda: resnet50_layer3(net, torch.from_numpy(
        rng.rand(1, 32, 32, 3).astype(np.float32))))
    assert net._fold is not None
    assert list(net.state_dict()) == keys == list(resnet50.ResNet50Layer3().state_dict())
    assert not any("fold" in k for k in keys)


def test_forty_epilogues_a_trunk_pass(rng, monkeypatch):
    """Kernel 14's wrapper is called 40 times a frozen trunk pass (the stem
    and 13 blocks x 3) and never on an unfolded one; on the CPU it takes the
    plain version, which counts no launch."""
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return conv_epilogue(*args, **kwargs)

    monkeypatch.setattr(resnet50, "conv_epilogue", counted)
    net = _trunk()
    x = torch.from_numpy(rng.rand(2, 32, 48, 3).astype(np.float32))
    kernels.reset_launch_counts()
    for passes in (1, 2):
        calls.clear()
        for _ in range(passes):
            _folded(lambda: resnet50_layer3(net, x))
        assert len(calls) == 40 * passes
    calls.clear()
    _unfolded(lambda: resnet50_layer3(net, x))
    assert not calls
    assert kernels.launch_counts()["conv_epilogue"] == 0


@pytest.mark.parametrize("residual", [True, False])
def test_conv_epilogue_ref(rng, residual):
    """The plain version: in place, (x + bias[c]) + residual, then ReLU."""
    x = torch.from_numpy(rng.randn(2, 5, 7, 9).astype(np.float32))
    bias = torch.from_numpy(rng.randn(5).astype(np.float32))
    res = torch.from_numpy(rng.randn(2, 5, 7, 9).astype(np.float32)) if residual else None
    want = x + bias.view(1, -1, 1, 1)
    if residual:
        want = want + res
    want = torch.relu(want)
    y = x.clone()
    out = conv_epilogue(y, bias, res)
    assert out is y
    assert torch.equal(y, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 64, 240, 320), (1, 1024, 15, 20), (1, 1024, 25, 33),
                                   (3, 5, 1, 3), (1, 7, 2, 2)])
def test_conv_epilogue_kernel_on_card(cuda, shape):
    """Kernel 14 against its plain version bit for bit: whole float4 planes,
    planes of 825 and 3 elements (ragged heads and tails), planes smaller
    than a float4, with and without the residual, and on views whose base
    is not 16-byte aligned (scalar path); one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(0)
    n, c, h, w = shape
    for offset in (0, 1):
        flat = torch.randn(n * c * h * w + offset, generator=g, device=cuda)
        flat[offset] = float("nan")  # passes ReLU as torch.relu's does
        x = flat[offset:].view(shape)
        bias = torch.randn(c, generator=g, device=cuda)
        res = torch.randn(n * c * h * w + offset, generator=g, device=cuda)[offset:].view(shape)
        for residual in (res, None):
            want = conv_epilogue_ref(x.clone(), bias, residual)
            got = x.clone() if offset == 0 else flat.clone()[offset:].view(shape)
            kernels.reset_launch_counts()
            out = conv_epilogue(got, bias, residual)
            torch.cuda.synchronize()
            assert out is got and kernels.launch_counts()["conv_epilogue"] == 1
            assert torch.equal(got.nan_to_num(), want.nan_to_num())
            assert torch.isnan(got.view(-1)[0]) and torch.isnan(want.view(-1)[0])


@pytest.mark.gpu
def test_folded_trunk_on_card(cuda, rng):
    """The frozen trunk on the card against its unfolded forward (TF32 off),
    40 launches of kernel 14 a pass."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        net = _trunk().to(cuda)
        x = torch.from_numpy(rng.rand(2, 240, 320, 3).astype(np.float32)).to(cuda)
        kernels.reset_launch_counts()
        with torch.inference_mode():
            got = resnet50_layer3(net, x)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["conv_epilogue"] == 40
        _close(got, _unfolded(lambda: resnet50_layer3(net, x)))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
