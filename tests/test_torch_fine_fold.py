"""The fine networks' frozen forward: their BatchNorm folded into the
convolutions, each convolution one call of kernel 15 (`kernels/fine_conv`).

On the CPU: the packed weight's layout, the plain version (conv, bias,
shortcut, ReLU), a transliteration of the kernel's index math and split-K
sums against the convolution, the wrapper's refusals, the tile plan, the
folded extractor, blocks and heads against their unfolded forward, the
unfolded paths (grad, train mode, the bf16 eval policy) bit for bit the
forward they had before the fold, the trunk's frozen forward bit for bit
PR 23's, the fold made anew after an edit of a head's conv4, and 42 calls a
fine pass. The `gpu` tests hold the kernel to its plain version and the
frozen fine pass to the unfolded one on the card.
"""

import copy
import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ransacflow_tpu_torch import kernels
from ransacflow_tpu_torch.kernels import fine_conv as fc
from ransacflow_tpu_torch.kernels.conv_epilogue import conv_epilogue_ref
from ransacflow_tpu_torch.kernels.fine_conv import fine_conv, fine_conv_ref, pack_conv
from ransacflow_tpu_torch.models import layers
from ransacflow_tpu_torch.models.convert import init_alignment_params, init_resnet50_layer3
from ransacflow_tpu_torch.models.feature_extractor import (
    BasicBlock,
    FeatureExtractor,
    feature_extractor,
)
from ransacflow_tpu_torch.models.heads import Head, head_logits
from ransacflow_tpu_torch.models.layers import cast_params, fold_bn, nchw, nhwc
from ransacflow_tpu_torch.pipeline.fine import fine_features, pred_flow_mask_homography

# the modules (`models` exports functions under their names)
fe_module = importlib.import_module("ransacflow_tpu_torch.models.feature_extractor")
heads_module = importlib.import_module("ransacflow_tpu_torch.models.heads")
FOLD_RTOL = 1e-5  # of the largest magnitude: the fold's rounding moves ~1e-6
# the fine stage's convolutions at one 480x640 pair: (M, N, K)
FINE_SHAPES = {"stem": (307200, 64, 27), "layer1": (76800, 64, 576),
               "layer2_conv1": (19200, 128, 576), "layer2": (19200, 128, 1152),
               "layer2_down": (19200, 128, 64), "layer3_conv1": (4800, 256, 1152),
               "layer3": (4800, 256, 2304), "layer3_down": (4800, 256, 128),
               "head_conv1": (4800, 512, 441), "head_conv2": (4800, 256, 4608),
               "head_conv3": (4800, 128, 2304), "flow_conv4": (4800, 49, 1152),
               "match_conv4": (4800, 1, 1152)}
H100_SMS, H100_BLOCKS_PER_SM = 132, (2, 3)  # read on the card (`rf_fine_conv_occupancy`)


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
    return net.eval()


def _seeded(net, seed):
    g = torch.Generator().manual_seed(seed)
    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            layers.kaiming_normal_(m, g)
    return _perturb_bn(net, seed)


def _net(kind, seed=0):
    """(module, input NHWC shape, the module's forward on an NHWC input)."""
    if kind == "extractor":
        return _seeded(FeatureExtractor(), seed), (2, 37, 45, 3), feature_extractor
    if kind in ("block_identity", "block_downsample"):
        cin, stride = (16, 1) if kind == "block_identity" else (8, 2)
        return (_seeded(BasicBlock(cin, 16, stride), seed), (2, 13, 18, cin),
                lambda net, x: nhwc(net(nchw(x))))
    cout = 49 if kind == "flow_head" else 1
    return _seeded(Head(7, cout), seed), (2, 9, 11, 49), head_logits


def _close(got, want, rtol=FOLD_RTOL):
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= rtol * scale, f"max abs err {err} against a largest {scale}"


def _unfolded(fn):
    """fn() with grad on: the modules take their unfolded forward."""
    with torch.enable_grad():
        return fn().detach()


# the forwards the modules had before the fold, written out
def _seed_block(b, x):
    out = F.relu(b.bn1(b.conv1(x)))
    out = b.bn2(b.conv2(out))
    res = x if b.downsample is None else b.downsample(x)
    return F.relu(out + res)


def _seed_extractor(net, x):
    x = F.relu(net.bn1(net.conv1(x)))
    x = net.blur(F.max_pool2d(x, 2, 1))
    if not torch.is_grad_enabled():
        x = x.contiguous()
    for layer in (net.layer1, net.layer2, net.layer3):
        for b in layer:
            x = _seed_block(b, x)
    return x


def _seed_head(net, x):
    for i in (1, 2, 3):
        x = F.relu(getattr(net, f"bn{i}")(getattr(net, f"conv{i}")(x)))
    return net.conv4(x)


def _seed_forward(kind, net, x):
    """The seed's forward on an NHWC input, NHWC out."""
    if kind == "extractor":
        return nhwc(_seed_extractor(net, nchw(x)))
    if kind.startswith("block"):
        return nhwc(_seed_block(net, nchw(x)))
    return nhwc(_seed_head(net, nchw(x)))


def _folds(net):
    return [m._fold for m in net.modules() if isinstance(m, layers.FrozenBNFold)]


def test_fine_conv_is_registered():
    assert kernels.KERNELS["fine_conv"] is fc.KERNEL
    assert fc.KERNEL.symbol == "rf_fine_conv"


@pytest.mark.parametrize("cin,cout,k", [(3, 64, 3), (49, 512, 3), (128, 49, 3), (128, 1, 3),
                                        (64, 128, 1)])
def test_pack_conv_layout(cin, cout, k):
    """Row k = (r * S + s) * Cin + c of the output channels, Cout rounded up
    to 4 with zero columns; `unpacked_weight` gives the weight back."""
    w = torch.randn(cout, cin, k, k, generator=torch.Generator().manual_seed(cin))
    pc = pack_conv(w, None, 1, k // 2)
    npad = -(-cout // 4) * 4
    assert pc.weight.shape == (k * k * cin, npad) and pc.weight.is_contiguous()
    assert torch.equal(pc.weight[:, cout:], torch.zeros(k * k * cin, npad - cout))
    r, s, c, n = 1 % k, (k - 1), cin - 1, cout - 1
    assert pc.weight[(r * k + s) * cin + c, n] == w[n, c, r, s]
    assert torch.equal(fc.unpacked_weight(pc), w)


@pytest.mark.parametrize("cin,cout,k,stride,epilogue",
                         [(3, 16, 3, 1, "relu"), (16, 16, 3, 1, "shortcut"),
                          (16, 32, 3, 2, "relu"), (16, 32, 1, 1, "none"),
                          (49, 24, 3, 1, "relu"), (32, 1, 3, 1, "none")])
def test_fine_conv_ref_is_conv_bias_shortcut_relu(rng, cin, cout, k, stride, epilogue):
    """The plain version, NHWC in and out: the convolution, then + bias, +
    shortcut, ReLU in that order, bit for bit the ops written out."""
    g = torch.Generator().manual_seed(cin + cout)
    x = torch.from_numpy(rng.randn(2, 11, 14, cin).astype(np.float32))
    w = torch.randn(cout, cin, k, k, generator=g)
    bias = None if epilogue == "none" else torch.randn(cout, generator=g)
    y = F.conv2d(nchw(x), w, None, stride, k // 2)
    res = torch.randn(y.shape, generator=g) if epilogue == "shortcut" else None
    if bias is not None:
        y = y + bias.view(1, -1, 1, 1)
        if res is not None:
            y = y + res
        y = torch.relu(y)
    got = fine_conv(x, pack_conv(w, bias, stride, k // 2), None if res is None else nhwc(res))
    assert got.is_contiguous() and got.shape == nhwc(y).shape
    assert torch.equal(got, nhwc(y))


def _emulate_kernel(x, pc, residual, bk, kps):
    """The kernel's arithmetic in fp64, written from `csrc/fine_conv.cu`:
    each k tile's A gathered as the kernel indexes it (one filter tap a
    tile of `bk` channels where Cin is a multiple of `bk`, else each element's
    tap decoded), zero-filled outside the image and past K and Npad, times
    the packed weight's rows; the splits' partial sums added in split
    order; then the epilogue."""
    b, h, w, cin = x.shape
    r_, st, pad = pc.kernel_size, pc.stride, pc.padding
    ho, wo = fc.out_hw(pc, h, w)
    m_all = torch.arange(b * ho * wo)
    bi, rem = m_all // (ho * wo), m_all % (ho * wo)
    ih0, iw0 = (rem // wo) * st - pad, (rem % wo) * st - pad
    xf = x.double().reshape(-1, cin)
    k_total = r_ * r_ * cin
    kt_total = -(-k_total // bk)
    wp = pc.weight.double()
    vec = cin % bk == 0
    partials = []
    for split in range(-(-kt_total // kps)):
        acc = torch.zeros(b * ho * wo, wp.shape[1], dtype=torch.float64)
        for kt in range(split * kps, min(kt_total, (split + 1) * kps)):
            kk = torch.arange(bk) + kt * bk
            if vec:
                rs = kt // (cin // bk)
                c = (kt - rs * (cin // bk)) * bk + torch.arange(bk)
                r, s = torch.full_like(c, rs // r_), torch.full_like(c, rs % r_)
                kok = torch.ones_like(c, dtype=torch.bool)
            else:
                kok = kk < k_total
                kc = kk.clamp_max(k_total - 1)
                r, s, c = kc // (r_ * cin), (kc % (r_ * cin)) // cin, kc % cin
            ih, iw = ih0[:, None] + r[None], iw0[:, None] + s[None]
            ok = kok[None] & (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)
            pix = (bi[:, None] * h + ih.clamp(0, h - 1)) * w + iw.clamp(0, w - 1)
            zero = torch.zeros((), dtype=torch.float64)
            a = torch.where(ok, xf[pix, c[None].expand_as(pix)], zero)
            wrows = torch.where((kk < k_total)[:, None], wp[kk.clamp_max(k_total - 1)], zero)
            acc += a @ wrows
        partials.append(acc)
    y = partials[0]
    for p in partials[1:]:
        y = y + p
    y = y[:, :pc.cout]
    if pc.bias is not None:
        y = y + pc.bias.double()
        if residual is not None:
            y = y + residual.double().reshape(-1, pc.cout)
        y = y.clamp_min(0)
    return y.reshape(b, ho, wo, pc.cout)


@pytest.mark.parametrize("cin,cout,k,stride,hw,epilogue,bk,kps",
                         [(3, 64, 3, 1, (21, 26), "relu", 16, 2),      # the stem: element path
                          (49, 40, 3, 1, (9, 11), "relu", 16, 8),      # the heads' conv1
                          (49, 72, 3, 1, (9, 11), "relu", 32, 5),      # wide tile, split
                          (16, 24, 3, 2, (13, 18), "relu", 16, 3),     # stride 2, split-K
                          (32, 16, 3, 1, (9, 10), "shortcut", 16, 5),  # ragged last split
                          (64, 96, 3, 1, (9, 10), "shortcut", 32, 7),  # wide tile, 16-byte path
                          (16, 8, 1, 1, (7, 9), "none", 16, 1),        # the 1x1 downsample
                          (32, 1, 3, 1, (9, 11), "none", 16, 6)])      # the match head's conv4
def test_fine_conv_kernel_index_math_emulated(rng, cin, cout, k, stride, hw, epilogue, bk, kps):
    """The kernel's gather, packed-weight rows, split sums and epilogue,
    transliterated in fp64 at either tile config's k depth, against the
    convolution in fp64."""
    g = torch.Generator().manual_seed(cin * cout)
    x = torch.from_numpy(rng.randn(2, *hw, cin).astype(np.float32))
    w = torch.randn(cout, cin, k, k, generator=g)
    bias = None if epilogue == "none" else torch.randn(cout, generator=g)
    pc = pack_conv(w, bias, stride, k // 2)
    ho, wo = fc.out_hw(pc, *hw)
    res = (torch.from_numpy(rng.randn(2, ho, wo, cout).astype(np.float32))
           if epilogue == "shortcut" else None)
    want = F.conv2d(nchw(x).double(), w.double(), None, stride, k // 2)
    if bias is not None:
        want = want + bias.double().view(1, -1, 1, 1)
        if res is not None:
            want = want + nchw(res).double()
        want = want.clamp_min(0)
    got = _emulate_kernel(x, pc, res, bk, kps)
    torch.testing.assert_close(got, nhwc(want), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", ["dtype", "nchw_layout", "channels", "residual_shape",
                                  "residual_without_bias", "weight_device", "too_many_pixels",
                                  "grad"])
def test_fine_conv_refuses(case):
    """The wrapper raises on what the kernel does not take (on the CPU as on
    the card, before it dispatches), and under grad on an input that
    requires it (forward only)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 8, 9, 16, generator=g)
    pc = pack_conv(torch.randn(8, 16, 3, 3, generator=g), torch.randn(8, generator=g), 1, 1)
    res = torch.randn(1, 8, 9, 8, generator=g)
    err = ValueError
    if case == "dtype":
        x = x.bfloat16()
    elif case == "nchw_layout":
        x = nchw(x).contiguous().permute(0, 2, 3, 1)  # an NHWC view of NCHW memory
    elif case == "channels":
        x = torch.randn(1, 8, 9, 12, generator=g)
    elif case == "residual_shape":
        res = torch.randn(1, 8, 9, 4, generator=g)
    elif case == "residual_without_bias":
        pc = pc._replace(bias=None)
    elif case == "weight_device":
        pc = pc._replace(weight=pc.weight.to("meta"))
    elif case == "too_many_pixels":  # 2**31 pixels, on the meta device: no memory
        x = torch.empty(2**29, 2, 2, 16, device="meta")
        pc = pc._replace(weight=pc.weight.to("meta"), bias=pc.bias.to("meta"))
        res = None
    else:
        x.requires_grad_()
        err = RuntimeError
    with torch.enable_grad(), pytest.raises(err):
        fine_conv(x, pc, res)


@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("name", sorted(FINE_SHAPES))
def test_plan_at_the_fine_stage_shapes(name, batch):
    """The tile plan at each fine-stage convolution of the alignment cells:
    split-K only where the tiles alone hold fewer blocks than the card holds
    at once, each split at least 128 k deep; one pair's K-heavy calls split;
    the busiest SM's modelled work within 1.35x of an even share."""
    m, n, k = FINE_SHAPES[name]
    m *= batch
    cfg, kps = fc.plan(m, n, k, H100_SMS, H100_BLOCKS_PER_SM)
    kt = -(-k // fc.BLOCK_K[cfg])
    splits = -(-kt // kps)
    tiles = -(-m // fc.BLOCK_M) * -(-n // fc.BLOCK_N[cfg])
    assert cfg == 1 or n > fc.BLOCK_N[1]
    if splits > 1:
        assert (tiles < H100_SMS * H100_BLOCKS_PER_SM[cfg]
                and kps * fc.BLOCK_K[cfg] >= fc.MIN_SPLIT_K)
    if batch == 32:
        assert splits == 1
    if batch == 1 and name in ("head_conv2", "head_conv3", "layer3"):
        assert splits > 1
    work = (-(-m // fc.BLOCK_M) * fc.BLOCK_M * -(-n // fc.BLOCK_N[cfg]) * fc.BLOCK_N[cfg] * kt
            * fc.BLOCK_K[cfg])
    busiest = (-(-tiles * splits // H100_SMS) * fc.BLOCK_M * fc.BLOCK_N[cfg] * kps
               * fc.BLOCK_K[cfg])
    if batch == 32 or name in ("head_conv2", "layer3", "layer3_conv1", "layer2"):
        assert busiest <= 1.35 * work / H100_SMS


@pytest.mark.parametrize("kind", ["extractor", "block_identity", "block_downsample",
                                  "flow_head", "match_head"])
def test_folded_fine_networks_match_unfolded(rng, kind):
    """Frozen (folded, kernel 15's plain version on the CPU) against the
    unfolded forward: the extractor (the stem's Cin 3, stride-2 blocks,
    blur-pooled downsamples), a block with and without its downsample, the
    flow head (Cin 49, Cout 49) and the matchability head (Cout 1). The
    result is contiguous NHWC, folded again bit for bit."""
    net, shape, fn = _net(kind)
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32))
    with torch.inference_mode():  # the serving path's mode folds outside it
        got = fn(net, x)
    folds = _folds(net)
    assert folds and all(f is not None for f in folds)
    assert got.is_contiguous()
    _close(got, _unfolded(lambda: fn(net, x)))
    with torch.no_grad():
        torch.testing.assert_close(fn(net, x), got, rtol=0, atol=0)


@pytest.mark.parametrize("path", ["grad", "train", "bf16"])
@pytest.mark.parametrize("kind", ["extractor", "flow_head"])
def test_unfolded_fine_paths_bit_for_bit(rng, kind, path):
    """Under grad (an input that requires it), in train mode and under the
    bf16 eval policy the fine networks run the forward they had before the
    fold, bit for bit, and fold nothing."""
    net, shape, fn = _net(kind)
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32))
    if path == "grad":
        x.requires_grad_()
        got = fn(net, x)
        want = _seed_forward(kind, net, x)
        got.sum().backward()  # the graph is whole
        assert x.grad is not None
    elif path == "train":
        a, b = copy.deepcopy(net).train(), copy.deepcopy(net).train()
        with torch.no_grad():
            got, want = fn(a, x), _seed_forward(kind, b, x)
        for (ka, va), (_, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(va, vb), ka  # the running statistics moved alike
        net = a
    else:
        net = cast_params(net, "bfloat16")
        xb = x.bfloat16()
        with torch.no_grad():
            got, want = fn(net, xb), _seed_forward(kind, net, xb)
        assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert all(f is None for f in _folds(net))


def _pr23_bottleneck(blk, x):
    """PR 23's frozen `Bottleneck` forward, written out."""
    (w1, b1), (w2, b2), (w3, b3) = (fold_bn(blk.conv1, blk.bn1), fold_bn(blk.conv2, blk.bn2),
                                    fold_bn(blk.conv3, blk.bn3))
    if blk.downsample is not None:
        wd, bd = fold_bn(*blk.downsample)
        b3 = b3 + bd
    c2 = blk.conv2
    out = conv_epilogue_ref(F.conv2d(x, w1), b1.float())
    out = conv_epilogue_ref(F.conv2d(out, w2, None, c2.stride, c2.padding, c2.dilation),
                            b2.float())
    res = x if blk.downsample is None else F.conv2d(x, wd, None, blk.downsample[0].stride)
    return conv_epilogue_ref(F.conv2d(out, w3), b3.float(), res)


def test_trunk_frozen_forward_unchanged(rng):
    """The trunk's frozen forward is PR 23's bit for bit: `FrozenBNFold`'s
    convolutions without a BatchNorm (the heads' conv4) change nothing of
    the trunk's fold."""
    net = _perturb_bn(init_resnet50_layer3(torch.Generator().manual_seed(0), "cpu"), 0)
    x = nchw(torch.from_numpy(rng.rand(2, 64, 80, 3).astype(np.float32)))
    w, b = fold_bn(net.conv1, net.bn1)
    want = conv_epilogue_ref(F.conv2d(x, w, None, net.conv1.stride, net.conv1.padding),
                             b.float())
    want = F.max_pool2d(want, 3, 2, 1)
    for layer in (net.layer1, net.layer2, net.layer3):
        for blk in layer:
            want = _pr23_bottleneck(blk, want)
    with torch.no_grad():
        got = net(x)
    assert all(f is not None for f in _folds(net))
    assert torch.equal(got, want)


def test_head_fold_follows_conv4_edits(rng):
    """A head's conv4, which no BatchNorm follows, is a source of the fold:
    an in-place edit of its weight makes the fold anew."""
    net, shape, fn = _net("flow_head")
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32))
    with torch.no_grad():
        first = fn(net, x).clone()
        fold = net._fold
        net.conv4.weight.mul_(-2.0)
        got = fn(net, x)
    assert net._fold is not fold
    _close(got, _unfolded(lambda: fn(net, x)))
    assert not torch.allclose(got, first)


def test_fine_pass_calls_fine_conv_42_times(rng, monkeypatch):
    """A frozen fine pass (the target's features, then
    `pred_flow_mask_homography`) calls kernel 15's wrapper 42 times: 15 for
    each extractor pass, 4 for each of the three head trunks; an unfolded
    pass (train mode) none. On the CPU it takes the plain version, which
    counts no launch."""
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return fine_conv(*args, **kwargs)

    monkeypatch.setattr(fe_module, "fine_conv", counted)
    monkeypatch.setattr(heads_module, "fine_conv", counted)
    align = init_alignment_params(torch.Generator().manual_seed(1), "cpu")
    src = torch.from_numpy(rng.rand(1, 64, 80, 3).astype(np.float32))
    tgt = torch.from_numpy(rng.rand(1, 64, 80, 3).astype(np.float32))
    h = torch.eye(3)[None]
    kernels.reset_launch_counts()
    out = pred_flow_mask_homography(align, src, fine_features(align, tgt), h, (64, 80))
    assert len(calls) == 42 and torch.isfinite(out["flow"]).all()
    calls.clear()
    for net in align.values():
        net.train()
    pred_flow_mask_homography(align, src, fine_features(align, tgt), h, (64, 80))
    assert not calls
    assert kernels.launch_counts()["fine_conv"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout,k,stride,hw,epilogue,batch",
                         [(3, 64, 3, 1, (97, 131), "relu", 2),
                          (64, 64, 3, 1, (48, 64), "shortcut", 3),
                          (64, 128, 3, 2, (48, 64), "relu", 2),
                          (64, 128, 1, 1, (24, 32), "none", 2),
                          (49, 512, 3, 1, (60, 80), "relu", 1),
                          (512, 256, 3, 1, (60, 80), "relu", 1),
                          (128, 49, 3, 1, (60, 80), "none", 1),
                          (128, 1, 3, 1, (61, 83), "none", 2)])
def test_fine_conv_kernel_on_card(cuda, cin, cout, k, stride, hw, epilogue, batch):
    """Kernel 15 against its plain version (cuDNN, TF32 off) within 2e-5 of
    the largest output: the element path (Cin 3, 49), the 16-byte path,
    stride 2, the 1x1 downsample, split-K at one pair's heads, Cout 49 and 1
    (element stores), ragged M; one launch a call."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        g = torch.Generator(device=cuda).manual_seed(cin + cout)
        x = torch.rand((batch, *hw, cin), generator=g, device=cuda)
        w = torch.randn((cout, cin, k, k), generator=g, device=cuda) * (2 / (k * k * cin)) ** 0.5
        bias = None if epilogue == "none" else torch.randn((cout,), generator=g, device=cuda)
        pc = pack_conv(w, bias, stride, k // 2)
        ho, wo = fc.out_hw(pc, *hw)
        res = (torch.randn((batch, ho, wo, cout), generator=g, device=cuda)
               if epilogue == "shortcut" else None)
        kernels.reset_launch_counts()
        with torch.inference_mode():
            got = fine_conv(x, pc, res)
            want = fine_conv_ref(x, pc, res)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["fine_conv"] == 1
        _close(got, want, 2e-5)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.gpu
def test_folded_fine_networks_on_card(cuda, rng):
    """The frozen extractor and heads on the card against their unfolded
    forward (TF32 off): 15 launches of kernel 15 an extractor pass, 4 a
    head."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for kind, shape in (("extractor", (2, 120, 160, 3)), ("flow_head", (2, 30, 40, 49)),
                            ("match_head", (1, 30, 40, 49))):
            net, _, fn = _net(kind)
            net = net.to(cuda)
            x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(cuda)
            kernels.reset_launch_counts()
            with torch.inference_mode():
                got = fn(net, x)
            torch.cuda.synchronize()
            assert kernels.launch_counts()["fine_conv"] == (15 if kind == "extractor" else 4)
            _close(got, _unfolded(lambda: fn(net, x)))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
