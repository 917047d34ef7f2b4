"""Weights for both sides: made on the device from the seed in one large
draw, or read from a committed file, as flat state_dict-named dicts that the
program's modules load and the plain reference computes with."""

import numpy as np
import torch

from portbench.reference import nets


def seeded(spec, generator, std_of=nets.kaiming_std, overrides=None):
    """{key: tensor} for a `nets.*_spec()`: every conv weight N(0, std) from
    one draw of all of them on the generator's device, each scaled by its
    std (`overrides` {key: std} replaces a std); BatchNorm at its identity
    (weight 1, bias 0, running mean 0, running variance 1)."""
    overrides = overrides or {}
    device = generator.device
    convs = [(k, s) for k, s, kind in spec if kind == "conv"]
    flat = torch.randn(sum(int(np.prod(s)) for _, s in convs), generator=generator,
                       device=device)
    out, at = {}, 0
    for key, shape in convs:
        n = int(np.prod(shape))
        out[key] = flat[at:at + n].view(shape) * overrides.get(key, std_of(shape))
        at += n
    fill = {"bn_weight": 1.0, "bn_bias": 0.0, "bn_running_mean": 0.0, "bn_running_var": 1.0}
    for key, shape, kind in spec:
        if kind != "conv":
            out[key] = torch.full(shape, fill[kind], device=device)
    return out


def from_npz(path, device):
    """{net name: {key: tensor}} of a file in the JAX package's flat format
    ('/'-joined keys, convolutions HWIO): float32, convolutions OIHW."""
    nets_ = {}
    with np.load(path) as f:
        for key in f.files:
            net, *rest = key.split("/")
            arr = np.asarray(f[key], np.float32)
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            nets_.setdefault(net, {})[".".join(rest)] = torch.from_numpy(
                np.ascontiguousarray(arr)).to(device)
    return nets_


def load_into(module, params):
    """Copy `params` into a module of the program: every key of the module's
    state_dict but BatchNorm's batch count must be given, and no other.
    Returns the module in eval mode."""
    missing, unexpected = module.load_state_dict(params, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"weights do not fit the program's module: missing {missing}, "
                       f"unexpected {unexpected}")
    return module.eval()
