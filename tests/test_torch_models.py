"""Parity of the PyTorch port's networks with the JAX package, on the CPU.

Weights move from the JAX init trees (`init_resnet50_layer3(PRNGKey(0))`,
`init_alignment_params(PRNGKey(1))`) with `tree_to_state_dict`; BatchNorm
statistics are perturbed first so that eval-mode BN is exercised.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ransacflow_tpu.models import heads as jheads
from ransacflow_tpu.models import layers as jlayers
from ransacflow_tpu.models import resnet50 as jresnet
from ransacflow_tpu.models import state_dict_to_tree
from ransacflow_tpu.models.feature_extractor import feature_extractor as j_feature_extractor
from ransacflow_tpu.models.resnet50 import init_resnet50_layer3 as j_init_resnet
from ransacflow_tpu.pipeline import init_alignment_params as j_init_align
from ransacflow_tpu_torch.models import convert, layers, resnet50
from ransacflow_tpu_torch.models.feature_extractor import feature_extractor
from ransacflow_tpu_torch.models.heads import net_flow_coarse, net_matchability
from ransacflow_tpu_torch.pipeline import init_alignment_params


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np_tree(tree, rng):
    """The tree as numpy, with BN statistics and affine moved off identity."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _np_tree(v, rng)
        else:
            out[k] = np.asarray(v, np.float32)
    if "running_mean" in out:
        c = out["running_mean"].shape[0]
        out["running_mean"] = (0.1 * rng.randn(c)).astype(np.float32)
        out["running_var"] = (0.75 + 0.5 * rng.rand(c)).astype(np.float32)
        out["weight"] = (1 + 0.1 * rng.randn(c)).astype(np.float32)
        out["bias"] = (0.1 * rng.randn(c)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def trees():
    rng = np.random.RandomState(5)
    return (_np_tree(j_init_resnet(jax.random.PRNGKey(0)), rng),
            _np_tree(j_init_align(jax.random.PRNGKey(1)), rng))


def close(ours, ref, atol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=atol)


def test_resnet50_layer3(rng, trees):
    tree = trees[0]
    net = convert.resnet50_layer3_from_tree(tree, "cpu")
    x = rng.rand(1, 64, 80, 3).astype(np.float32)
    close(resnet50.imagenet_preprocess(torch.from_numpy(x)),
          jresnet.imagenet_preprocess(jnp.asarray(x)), atol=1e-6)
    xin = jresnet.imagenet_preprocess(jnp.asarray(x))
    ref, _ = jresnet.resnet50_layer3(tree, xin)
    with torch.no_grad():
        ours = resnet50.resnet50_layer3(net, torch.from_numpy(np.array(xin)))
    assert ours.shape == (1, 4, 5, 1024) and ours.is_contiguous()
    close(ours, ref, atol=5e-4)  # as tests/test_models.py holds the trunk


def test_feature_extractor(rng, trees):
    tree = trees[1]["netFeatCoarse"]
    nets = convert.alignment_params_from_tree(trees[1], "cpu")
    x = rng.rand(2, 48, 64, 3).astype(np.float32)
    ref, _ = j_feature_extractor(tree, jnp.asarray(x))
    with torch.no_grad():
        ours = feature_extractor(nets["netFeatCoarse"], torch.from_numpy(x))
    assert ours.shape == (2, 6, 8, 256)
    close(ours, ref, atol=2e-4)


@pytest.mark.parametrize("up8", [False, True])
def test_heads(rng, trees, up8):
    nets = convert.alignment_params_from_tree(trees[1], "cpu")
    corr = rng.rand(1, 6, 7, 49).astype(np.float32)
    ref, _ = jheads.net_flow_coarse(trees[1]["netFlowCoarse"], jnp.asarray(corr), up8=up8)
    with torch.no_grad():
        ours = net_flow_coarse(nets["netFlowCoarse"], torch.from_numpy(corr), up8=up8)
    close(ours, ref, atol=2e-4)
    ref, _ = jheads.net_matchability(trees[1]["netMatch"], jnp.asarray(corr), up8=up8)
    with torch.no_grad():
        ours = net_matchability(nets["netMatch"], torch.from_numpy(corr), up8=up8)
    close(ours, ref, atol=2e-4)


def test_l2_normalize(rng):
    x = rng.randn(2, 4, 5, 16).astype(np.float32)
    x[0, 0, 0] = 0.0  # the eps floor
    close(layers.l2_normalize(torch.from_numpy(x)),
          jlayers.l2_normalize(jnp.asarray(x)), atol=1e-6)


def test_tree_to_state_dict_inverts_state_dict_to_tree(trees):
    for tree in (trees[0], trees[1]["netFeatCoarse"], trees[1]["netMatch"]):
        back = state_dict_to_tree(convert.tree_to_state_dict(tree))
        flat = jax.tree_util.tree_leaves_with_path(back)
        assert len(flat) == len(jax.tree_util.tree_leaves(tree))
        for path, leaf in flat:
            node = tree
            for p in path:
                node = node[p.key]
            np.testing.assert_array_equal(np.asarray(leaf), node)


def test_checkpoint_loaders(tmp_path, trees):
    """The reference's .pth layouts load: `module.`/`model` (MoCo), layer4
    and fc entries skipped, blur-pool `filt` buffers dropped."""
    trunk = convert.tree_to_state_dict(trees[0])
    moco = {"model": {"module." + k: v for k, v in trunk.items()}}
    moco["model"]["module.layer4.0.conv1.weight"] = torch.zeros(1)
    moco["model"]["module.fc.weight"] = torch.zeros(1)
    torch.save(moco, tmp_path / "moco.pth")
    net = convert.load_resnet50_trunk(str(tmp_path / "moco.pth"), "cpu", moco=True)
    torch.testing.assert_close(net.layer3[5].conv3.weight, trunk["layer3.5.conv3.weight"])

    ckpt = {name: convert.tree_to_state_dict(trees[1][name])
            for name in ("netFeatCoarse", "netFlowCoarse", "netMatch")}
    ckpt["netCorr"] = {}
    ckpt["netFeatCoarse"]["layer2.0.downsample.0.filt"] = torch.ones(64, 1, 3, 3)
    torch.save(ckpt, tmp_path / "align.pth")
    nets = convert.load_alignment_checkpoint(str(tmp_path / "align.pth"), "cpu")
    torch.testing.assert_close(nets["netMatch"].conv4.weight,
                               ckpt["netMatch"]["conv4.weight"])
    assert not nets["netMatch"].training
    with pytest.raises(KeyError):
        convert.load_resnet50_trunk({"conv1.weight": torch.zeros(64, 3, 7, 7)}, "cpu")


def test_seeded_init_distributions():
    nets = init_alignment_params(torch.Generator().manual_seed(0), "cpu")
    w = nets["netFlowCoarse"].conv2.weight  # 3x3, 512 -> 256
    assert abs(w.std().item() - (2.0 / (9 * 256)) ** 0.5) < 0.002
    assert abs(nets["netMatch"].conv4.weight.std().item() - 1e-4) < 1e-5
    corr = torch.rand(1, 5, 6, 49)
    with torch.no_grad():
        m = net_matchability(nets["netMatch"], corr, up8=False)
    assert (m - 0.5).abs().max() < 0.01  # ~0.5 at init
    again = init_alignment_params(torch.Generator().manual_seed(0), "cpu")
    torch.testing.assert_close(again["netFeatCoarse"].conv1.weight,
                               nets["netFeatCoarse"].conv1.weight)
    trunk = convert.init_resnet50_layer3(torch.Generator().manual_seed(0), "cpu")
    assert abs(trunk.conv1.weight.std().item() - (2.0 / (49 * 64)) ** 0.5) < 0.002
