"""Weights for the networks: from a JAX parameter tree, from the released
`.pth` checkpoints, or seeded.

The JAX package's parameter trees already use the reference's `state_dict`
names (`ransacflow_tpu/models/convert.py`), so `tree_to_state_dict` is the
mechanical inverse of its `state_dict_to_tree`: HWIO -> OIHW, and the
`num_batches_tracked` buffer that a BatchNorm's state_dict carries.
"""

import numpy as np
import torch

from ransacflow_tpu_torch.device import as_device
from ransacflow_tpu_torch.models.feature_extractor import FeatureExtractor
from ransacflow_tpu_torch.models.heads import Head
from ransacflow_tpu_torch.models.layers import kaiming_normal_
from ransacflow_tpu_torch.models.resnet50 import ResNet50Layer3
from ransacflow_tpu_torch.models.segnet import PPMDecoder, SegNetEncoder

RESNET_TRUNK_SKIP = ("layer4.", "fc.", "avgpool.", "l2norm.")
# the reference decoder's deep-supervision head, which inference does not run
SEGNET_DEEPSUP_SKIP = ("cbr_deepsup.", "conv_last_deepsup.")


def tree_to_state_dict(tree):
    """Nested dict of arrays (a JAX parameter tree as numpy) -> flat torch
    state_dict."""
    sd = {}

    def walk(prefix, node):
        if "running_mean" in node:
            sd[prefix + "num_batches_tracked"] = torch.tensor(0)
        for key, val in node.items():
            if isinstance(val, dict):
                walk(f"{prefix}{key}.", val)
                continue
            arr = np.array(val, dtype=np.float32)  # a writable copy
            if arr.ndim == 4:  # conv HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            sd[prefix + key] = torch.from_numpy(np.ascontiguousarray(arr))

    walk("", tree)
    return sd


def _load_into(net, state_dict, device, skip_prefixes=()):
    """Load a reference state_dict: drop `module.`, skipped prefixes and the
    blur-pool `filt` constants; a missing `num_batches_tracked` is allowed."""
    sd = {}
    for key, val in state_dict.items():
        key = key.removeprefix("module.")
        if key.startswith(skip_prefixes) or key.endswith("filt"):
            continue
        sd[key] = val
    missing, unexpected = net.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"state_dict mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    return net.to(as_device(device)).eval()


def _alignment_nets(kernel_size):
    k2 = kernel_size * kernel_size
    return {"netFeatCoarse": FeatureExtractor(),
            "netFlowCoarse": Head(kernel_size, k2),
            "netMatch": Head(kernel_size, 1)}


def load_alignment_checkpoint(path, device, kernel_size=7):
    """The released RANSAC-Flow checkpoint (a dict of netFeatCoarse /
    netCorr / netFlowCoarse / netMatch state_dicts) -> dict of networks."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return {name: _load_into(net, ckpt[name], device)
            for name, net in _alignment_nets(kernel_size).items()}


def load_resnet50_trunk(path_or_state_dict, device, moco=False):
    """ResNet-50 weights (torchvision or MoCo, whose state_dict sits under
    'model' with `module.` prefixes) truncated at layer3."""
    sd = path_or_state_dict
    if isinstance(sd, str):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    if moco and "model" in sd:
        sd = sd["model"]
    return _load_into(ResNet50Layer3(), sd, device, RESNET_TRUNK_SKIP)


def resnet50_layer3_from_tree(tree, device):
    """The trunk with the weights of a JAX parameter tree."""
    return _load_into(ResNet50Layer3(), tree_to_state_dict(tree), device)


def alignment_params_from_tree(trees, device, kernel_size=7):
    """The alignment networks with the weights of the JAX package's
    `init_alignment_params`-shaped dict of trees."""
    return {name: _load_into(net, tree_to_state_dict(trees[name]), device)
            for name, net in _alignment_nets(kernel_size).items()}


def load_params_npz(path):
    """A parameter tree saved by the JAX package's `save_params_npz` (flat
    '/'-joined keys, e.g. `scripts/assets/accept_weights.npz`) -> nested dict
    of float32 numpy arrays, for `alignment_params_from_tree`."""
    tree = {}
    with np.load(path) as f:
        for key in f.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = np.asarray(f[key], np.float32)
    return tree


def _seeded(net, generator):
    """Every conv ~ kaiming normal (fan_out) from `generator` with a zero
    bias; BatchNorm keeps its identity init, as the JAX init does."""
    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            kaiming_normal_(m, generator)
            if m.bias is not None:
                torch.nn.init.zeros_(m.bias)
    return net


def init_resnet50_layer3(generator, device):
    """Seeded ResNet-50 trunk. `generator` is a CPU `torch.Generator`."""
    return _seeded(ResNet50Layer3(), generator).to(as_device(device)).eval()


def init_alignment_params(generator, device, kernel_size=7):
    """Seeded alignment networks (netFeatCoarse, netFlowCoarse, netMatch),
    the counterpart of `ransacflow_tpu/pipeline/api.py:27`; the matchability
    head's conv4 is N(0, 1e-4), so that the initial matchability is ~0.5.
    `generator` is a CPU `torch.Generator`."""
    nets = _alignment_nets(kernel_size)
    for net in nets.values():
        _seeded(net, generator)
    with torch.no_grad():
        nets["netMatch"].conv4.weight.normal_(0.0, 1e-4, generator=generator)
    return {name: net.to(as_device(device)).eval() for name, net in nets.items()}


def segnet_from_tree(enc_tree, dec_tree, device):
    """(SegNetEncoder, PPMDecoder) with the weights of the JAX package's
    segnet parameter trees."""
    return (_load_into(SegNetEncoder(), tree_to_state_dict(enc_tree), device),
            _load_into(PPMDecoder(), tree_to_state_dict(dec_tree), device))


def init_segnet(generator, device):
    """Seeded (SegNetEncoder, PPMDecoder). `generator` is a CPU
    `torch.Generator`."""
    return tuple(_seeded(net, generator).to(as_device(device)).eval()
                 for net in (SegNetEncoder(), PPMDecoder()))


def load_segnet(enc_pth, dec_pth, device):
    """The reference's ADE20k encoder and decoder checkpoints (plain
    state_dicts) -> (SegNetEncoder, PPMDecoder); the decoder's
    deep-supervision head is dropped."""
    def load(path):
        return torch.load(path, map_location="cpu", weights_only=True)

    return (_load_into(SegNetEncoder(), load(enc_pth), device),
            _load_into(PPMDecoder(), load(dec_pth), device, SEGNET_DEEPSUP_SKIP))
