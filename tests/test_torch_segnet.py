"""Parity of the PyTorch port's sky-mask network with the JAX package, on
the CPU.

The PPM pooling (kernel 13's plain version), the dilated encoder, the PPM
decoder, `SkySegmenter` and the eval hooks get the same numpy-seeded inputs
and the weights of JAX's init trees (carried over by `convert`), with one
small inference scale on both sides where the protocol allows it.
"""

import argparse

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from ransacflow_tpu.eval import sky as jsky
from ransacflow_tpu.models import segnet as jsegnet
from ransacflow_tpu_torch import kernels
from ransacflow_tpu_torch.cli.common import build_sky_fn
from ransacflow_tpu_torch.eval import sky
from ransacflow_tpu_torch.kernels.adaptive_pool import ppm_pool, ppm_pool_ref
from ransacflow_tpu_torch.models import convert, segnet

SMALL = (64,)  # one inference scale, both packages


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def nets():
    enc = jsegnet.init_segnet_encoder(jax.random.PRNGKey(0))
    dec = jsegnet.init_segnet_decoder(jax.random.PRNGKey(1))
    # non-trivial BatchNorm statistics, so that the eval-mode BN is checked
    rng = np.random.RandomState(9)

    def perturb(tree):
        if "running_mean" in tree:
            c = tree["running_mean"].shape[0]
            tree = dict(tree, running_mean=jnp.asarray(0.1 * rng.randn(c), jnp.float32),
                        running_var=jnp.asarray(1 + 0.2 * rng.rand(c), jnp.float32),
                        bias=jnp.asarray(0.1 * rng.randn(c), jnp.float32))
        return {k: perturb(v) if isinstance(v, dict) else v for k, v in tree.items()}

    enc, dec = perturb(enc), perturb(dec)
    return enc, dec, *convert.segnet_from_tree(enc, dec, "cpu")


def t(a):
    return torch.from_numpy(np.array(a))


def _image(rng, h=48, w=56):
    return Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8))


@pytest.mark.parametrize("shape", [(2, 13, 17, 4), (1, 12, 16, 2048)])
def test_ppm_pool_ref_matches_jax(rng, shape):
    x = rng.rand(*shape).astype(np.float32)
    ours = ppm_pool(t(x), segnet.POOL_SCALES)
    for s, got in zip(segnet.POOL_SCALES, ours):
        ref = np.asarray(jsegnet._adaptive_avg_pool(jnp.asarray(x), s))
        assert got.shape == ref.shape == (shape[0], s, s, shape[3])
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
        # and torch's own adaptive pool, the library-call yardstick
        lib = F.adaptive_avg_pool2d(t(x).permute(0, 3, 1, 2), s).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), lib.numpy(), atol=1e-6)


def test_dilated_conv_helper_matches_jax(rng):
    from ransacflow_tpu.models.layers import conv2d as j_conv2d
    from ransacflow_tpu_torch.models.layers import conv

    x = rng.randn(1, 16, 16, 8).astype(np.float32)
    w = rng.randn(3, 3, 8, 6).astype(np.float32)
    for d in (2, 4):
        m = conv(8, 6, 3, 1, d, d)
        with torch.no_grad():
            m.weight.copy_(t(w).permute(3, 2, 0, 1))
            ours = m(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        ref = j_conv2d(jnp.asarray(x), jnp.asarray(w), padding=d, dilation=d)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)


def test_encoder_matches_jax(rng, nets):
    enc, _, tenc, _ = nets
    x = rng.rand(1, 64, 80, 3).astype(np.float32)
    ref = np.asarray(jsegnet.segnet_encoder(enc, jnp.asarray(x)))
    with torch.no_grad():
        ours = segnet.segnet_encoder(tenc, t(x)).numpy()
    assert ours.shape == ref.shape == (1, 8, 10, 2048)
    # fp32 through 52 convolutions in two libraries: relative to the largest value
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()


def test_decoder_matches_jax_at_a_non_multiple_size(rng, nets):
    _, dec, _, tdec = nets
    conv5 = rng.rand(1, 8, 10, 2048).astype(np.float32)
    ref = np.asarray(jsegnet.segnet_decoder(dec, jnp.asarray(conv5), (33, 47)))
    with torch.no_grad():
        ours = tdec(t(conv5), (33, 47)).numpy()
    assert ours.shape == ref.shape == (1, 33, 47, 150)
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    np.testing.assert_allclose(ours.sum(-1), 1.0, atol=1e-5)


def _segmenters(nets, **kw):
    enc, dec, tenc, tdec = nets
    j = jsegnet.SkySegmenter(enc, dec, **kw)
    ours = segnet.SkySegmenter(tenc, tdec, "cpu", **kw)
    j.IMG_SIZES = ours.IMG_SIZES = SMALL
    return j, ours


def test_sky_segmenter_matches_jax(rng, nets):
    img = _image(rng)
    j, ours = _segmenters(nets)
    ref = j.class_scores(img)
    got = ours.class_scores(img)
    assert isinstance(got, torch.Tensor) and got.shape == ref.shape == (48, 56, 150)
    # the seeded logits span ~65 nats after 55 convolutions: a 1e-6 relative
    # difference of a logit moves a probability by up to ~6e-5
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    # a sky class that wins somewhere, so that the mask is not all zeros
    seg_id = int(np.bincount(ref.argmax(-1).ravel()).argmax())
    j.seg_id = ours.seg_id = seg_id
    np.testing.assert_array_equal(ours.get_sky(img), j.get_sky(img))
    assert ours.get_sky(img).sum() > 0
    ours.seg_fg = True
    np.testing.assert_array_equal(ours.get_sky(img), 1.0 - j.get_sky(img))


def test_sky_segmenter_at_the_default_scales(rng, nets):
    """The protocol's five scales, 300..600 capped at a long side of 500."""
    ours = segnet.SkySegmenter(nets[2], nets[3], "cpu")
    assert ours.IMG_SIZES == jsegnet.SkySegmenter.IMG_SIZES
    mask = ours.get_sky(_image(rng))
    assert mask.shape == (48, 56) and mask.dtype == np.float32
    assert set(np.unique(mask)) <= {0.0, 1.0}


def test_load_segnet_drops_the_deep_supervision_head(tmp_path, nets):
    enc, dec = convert.init_segnet(torch.Generator().manual_seed(3), "cpu")
    dec_sd = dict(dec.state_dict())
    dec_sd["cbr_deepsup.0.weight"] = torch.zeros(512, 1024, 3, 3)
    dec_sd["conv_last_deepsup.weight"] = torch.zeros(150, 512, 1, 1)
    dec_sd["conv_last_deepsup.bias"] = torch.zeros(150)
    torch.save(enc.state_dict(), tmp_path / "enc.pth")
    torch.save(dec_sd, tmp_path / "dec.pth")
    enc2, dec2 = convert.load_segnet(str(tmp_path / "enc.pth"), str(tmp_path / "dec.pth"),
                                     "cpu")
    for a, b in ((enc, enc2), (dec, dec2)):
        assert not b.training
        for (k, v), (k2, v2) in zip(a.state_dict().items(), b.state_dict().items()):
            assert k == k2 and torch.equal(v, v2), k
    assert (dec2.conv_last[4].bias == 0).all()  # the seeded init's zero bias
    with pytest.raises(KeyError):  # anything else unexpected still raises
        dec_sd["extra.weight"] = torch.zeros(1)
        torch.save(dec_sd, tmp_path / "dec_bad.pth")
        convert.load_segnet(str(tmp_path / "enc.pth"), str(tmp_path / "dec_bad.pth"), "cpu")


def test_sky_bg_fns_match_jax(rng, nets, tmp_path):
    path = str(tmp_path / "img.png")
    _image(rng).save(path)
    j, ours = _segmenters(nets)
    seg_id = int(np.bincount(j.class_scores(Image.open(path).convert("RGB"))
                             .argmax(-1).ravel()).argmax())
    j.seg_id = ours.seg_id = seg_id
    np.testing.assert_array_equal(sky.make_sky_bg_fn(ours)(path, (30, 41)),
                                  jsky.make_sky_bg_fn(j)(path, (30, 41)))
    for angle in (90, 180):
        np.testing.assert_array_equal(
            sky.make_sky_bg_fn_rotated(ours)(path, (41, 30), angle),
            jsky.make_sky_bg_fn_rotated(j)(path, (41, 30), angle))
    mask = (rng.rand(17, 23) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(sky.resize_mask(mask, (40, 31)),
                                  jsky.resize_mask(mask, (40, 31)))


def test_build_sky_fn_from_checkpoints(rng, tmp_path, monkeypatch):
    """The --segNet hook: checkpoints -> SkySegmenter -> bg mask fn."""
    enc, dec = convert.init_segnet(torch.Generator().manual_seed(4), "cpu")
    torch.save(enc.state_dict(), tmp_path / "enc.pth")
    torch.save(dec.state_dict(), tmp_path / "dec.pth")
    args = argparse.Namespace(segNet=True, segEncoderPth=str(tmp_path / "enc.pth"),
                              segDecoderPth=str(tmp_path / "dec.pth"))
    assert build_sky_fn(argparse.Namespace(segNet=False), "cpu") is None
    monkeypatch.setattr(segnet.SkySegmenter, "IMG_SIZES", SMALL)
    path = str(tmp_path / "img.png")
    _image(rng).save(path)
    bg = build_sky_fn(args, "cpu")(path, (32, 40))
    assert bg.shape == (32, 40) and set(np.unique(bg)) <= {0.0, 1.0}
    bg_rot = build_sky_fn(args, "cpu", rotated=True)(path, (40, 32), 90)
    assert bg_rot.shape == (40, 32)


def test_ppm_pool_takes_the_plain_version_on_cpu(rng):
    x = t(rng.rand(1, 7, 9, 8).astype(np.float32))
    kernels.reset_launch_counts()
    for a, b in zip(ppm_pool(x), ppm_pool_ref(x)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert kernels.launch_counts()["ppm_pool"] == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 47, 63, 2048), (2, 13, 17, 40), (1, 1, 5, 3)])
def test_ppm_pool_kernel_on_card(cuda, rng, shape):
    x = t(rng.rand(*shape).astype(np.float32)).to(cuda)
    kernels.reset_launch_counts()
    got = ppm_pool(x)
    assert kernels.launch_counts()["ppm_pool"] == 1  # every scale, one launch
    for g, r in zip(got, ppm_pool_ref(x)):
        assert g.shape == r.shape
        # fp32 means of up to ~3000 values in another order
        torch.testing.assert_close(g, r, atol=2e-6, rtol=1e-5)


@pytest.mark.gpu
def test_sky_segmenter_on_card_matches_cpu(cuda, rng):
    enc, dec = convert.init_segnet(torch.Generator().manual_seed(0), "cpu")
    cpu = segnet.SkySegmenter(enc, dec, "cpu")
    enc_g, dec_g = convert.init_segnet(torch.Generator().manual_seed(0), cuda)
    gpu = segnet.SkySegmenter(enc_g, dec_g, cuda)
    cpu.IMG_SIZES = gpu.IMG_SIZES = SMALL
    torch.backends.cudnn.allow_tf32 = False
    img = _image(rng)
    kernels.reset_launch_counts()
    scores = gpu.class_scores(img)
    assert kernels.launch_counts()["ppm_pool"] == 1
    # the seeded logits span ~65 nats: cuDNN's and the CPU's fp32 orders
    # through 55 convolutions move a logit by ~1e-4 and a probability by up
    # to a quarter of that times the logit's own scale
    torch.testing.assert_close(scores.cpu(), cpu.class_scores(img), atol=1e-3, rtol=0)
