"""The networks of RANSAC-Flow as plain functions of a flat parameter dict
(state_dict names), NCHW, float32: the ResNet-50 trunk through layer3, the
fine feature extractor and the flow / matchability heads.

Written from the reference's architecture (RANSAC-Flow, Shen et al., ECCV
2020, `model/resnet50.py` and `model/model.py`). It imports nothing of the
program: the benchmark makes the parameters, hands the same tensors to both
sides, and this module is the side that judges.

`mm` is the precision policy of every convolution: `exact` (fp32 operands)
or `tf32` (operands rounded to TF32's 10-bit mantissa, the sums in fp32),
the lower precision the control computes in.
"""

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BOTTLENECKS = (("layer1", 3, 64, 1), ("layer2", 4, 128, 2), ("layer3", 6, 256, 2))
BASIC = (("layer1", 64, 64, 1), ("layer2", 64, 128, 2), ("layer3", 128, 256, 2))
HEAD_TRUNK = (512, 256, 128)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def round_tf32(x):
    """x rounded to TF32 (1 sign, 8 exponent, 10 mantissa bits), to
    nearest even, kept in float32; the gradient passes through as is."""
    with torch.no_grad():
        bits = x.detach().contiguous().view(torch.int32)
        lsb = (bits >> 13) & 1
        rounded = ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach() if x.requires_grad else rounded


def conv(x, w, stride=1, padding=0, mm="exact"):
    if mm == "tf32":
        x, w = round_tf32(x), round_tf32(w)
    return F.conv2d(x, w, stride=stride, padding=padding)


def bn(x, p, key, train=False):
    """BatchNorm2d: running statistics in eval, the batch's biased moments in
    train mode (the running statistics are not updated here)."""
    return F.batch_norm(x, p[key + ".running_mean"], p[key + ".running_var"],
                        p[key + ".weight"], p[key + ".bias"], training=train,
                        momentum=0.0, eps=BN_EPS)


# ---------------------------------------------------------------- specs

def _bn_spec(key, c):
    return [(f"{key}.{n}", (c,), "bn_" + n) for n in ("weight", "bias", "running_mean",
                                                       "running_var")]


def resnet50_layer3_spec():
    """[(key, shape, kind)] of the trunk; kind 'conv' or 'bn_<field>'."""
    spec = [("conv1.weight", (64, 3, 7, 7), "conv")] + _bn_spec("bn1", 64)
    cin = 64
    for name, blocks, planes, _ in BOTTLENECKS:
        for b in range(blocks):
            k = f"{name}.{b}"
            spec += [(f"{k}.conv1.weight", (planes, cin, 1, 1), "conv")] + _bn_spec(f"{k}.bn1", planes)
            spec += [(f"{k}.conv2.weight", (planes, planes, 3, 3), "conv")] + _bn_spec(f"{k}.bn2", planes)
            spec += [(f"{k}.conv3.weight", (planes * 4, planes, 1, 1), "conv")]
            spec += _bn_spec(f"{k}.bn3", planes * 4)
            if b == 0:
                spec += [(f"{k}.downsample.0.weight", (planes * 4, cin, 1, 1), "conv")]
                spec += _bn_spec(f"{k}.downsample.1", planes * 4)
            cin = planes * 4
    return spec


def feature_extractor_spec():
    spec = [("conv1.weight", (64, 3, 3, 3), "conv")] + _bn_spec("bn1", 64)
    for name, cin, cout, stride in BASIC:
        for b in range(2):
            k, ci = f"{name}.{b}", cin if b == 0 else cout
            spec += [(f"{k}.conv1.weight", (cout, ci, 3, 3), "conv")] + _bn_spec(f"{k}.bn1", cout)
            spec += [(f"{k}.conv2.weight", (cout, cout, 3, 3), "conv")] + _bn_spec(f"{k}.bn2", cout)
            if b == 0 and stride != 1:
                spec += [(f"{k}.downsample.1.weight", (cout, ci, 1, 1), "conv")]
                spec += _bn_spec(f"{k}.downsample.2", cout)
    return spec


def head_spec(kernel_size, out_ch):
    widths = (kernel_size * kernel_size,) + HEAD_TRUNK
    spec = []
    for i in range(3):
        spec += [(f"conv{i + 1}.weight", (widths[i + 1], widths[i], 3, 3), "conv")]
        spec += _bn_spec(f"bn{i + 1}", widths[i + 1])
    return spec + [("conv4.weight", (out_ch, HEAD_TRUNK[-1], 3, 3), "conv")]


def alignment_specs(kernel_size):
    k2 = kernel_size * kernel_size
    return {"netFeatCoarse": feature_extractor_spec(),
            "netFlowCoarse": head_spec(kernel_size, k2),
            "netMatch": head_spec(kernel_size, 1)}


# ---------------------------------------------------------------- forwards

def imagenet_preprocess(x):
    """(B, H, W, 3) in [0, 1] -> NCHW ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def resnet50_layer3(p, x, mm="exact"):
    """NCHW images -> NCHW (B, 1024, H/16, W/16)."""
    x = F.relu(bn(conv(x, p["conv1.weight"], 2, 3, mm), p, "bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    for name, blocks, _, stride in BOTTLENECKS:
        for b in range(blocks):
            k, s = f"{name}.{b}", stride if b == 0 else 1
            out = F.relu(bn(conv(x, p[f"{k}.conv1.weight"], 1, 0, mm), p, f"{k}.bn1"))
            out = F.relu(bn(conv(out, p[f"{k}.conv2.weight"], s, 1, mm), p, f"{k}.bn2"))
            out = bn(conv(out, p[f"{k}.conv3.weight"], 1, 0, mm), p, f"{k}.bn3")
            res = x
            if b == 0:
                res = bn(conv(x, p[f"{k}.downsample.0.weight"], s, 0, mm), p, f"{k}.downsample.1")
            x = F.relu(out + res)
    return x


def blur_pool(x, stride=2):
    """Reflect pad 1, the normalized 3x3 binomial filter, depthwise, stride
    (the reference's Downsample, filt_size 3)."""
    a = torch.tensor([1.0, 2.0, 1.0], dtype=x.dtype, device=x.device)
    f = torch.outer(a, a) / 16.0
    c = x.shape[1]
    x = F.pad(x, (1, 1, 1, 1), mode="reflect")
    return F.conv2d(x, f.expand(c, 1, 3, 3), stride=stride, groups=c)


def feature_extractor(p, x, train=False, mm="exact"):
    """NCHW images in [0, 1] -> NCHW (B, 256, H/8, W/8)."""
    x = F.relu(bn(conv(x, p["conv1.weight"], 1, 1, mm), p, "bn1", train))
    x = blur_pool(F.max_pool2d(x, 2, 1))
    for name, _, _, stride in BASIC:
        for b in range(2):
            k, s = f"{name}.{b}", stride if b == 0 else 1
            out = F.relu(bn(conv(x, p[f"{k}.conv1.weight"], s, 1, mm), p, f"{k}.bn1", train))
            out = bn(conv(out, p[f"{k}.conv2.weight"], 1, 1, mm), p, f"{k}.bn2", train)
            res = x
            if b == 0 and stride != 1:
                res = bn(conv(blur_pool(x, stride), p[f"{k}.downsample.1.weight"], 1, 0, mm),
                         p, f"{k}.downsample.2", train)
            x = F.relu(out + res)
    return x


def head(p, corr, train=False, mm="exact"):
    """NCHW (B, k^2, h, w) correlation -> conv4's NCHW logits."""
    x = corr
    for i in (1, 2, 3):
        x = F.relu(bn(conv(x, p[f"conv{i}.weight"], 1, 1, mm), p, f"bn{i}", train))
    return conv(x, p["conv4.weight"], 1, 1, mm)


def l2_normalize(x, dim):
    return x / torch.sqrt((x * x).sum(dim=dim, keepdim=True)).clamp_min(1e-12)


def correlation(x, y, kernel_size):
    """NCHW (B, C, h, w) x, y -> (B, k^2, h, w): channel di*k+dj holds
    sum_c x[:, c, i, j] * y[:, c, i+di-p, j+dj-p], zeros outside."""
    p = kernel_size // 2
    h, w = x.shape[2:]
    yp = F.pad(y, (p, p, p, p))
    return torch.stack([(x * yp[:, :, di:di + h, dj:dj + w]).sum(1)
                        for di in range(kernel_size) for dj in range(kernel_size)], dim=1)


def flow_epilogue(logits, kernel_size):
    """NCHW (B, k^2, h, w) logits -> (B, h, w, 2) flow: the softmax
    expectation of the (dx, dy) offsets, over the width / height, times 2."""
    prob = torch.softmax(logits, dim=1)
    idx = torch.arange(kernel_size * kernel_size, device=logits.device)
    gx = (idx % kernel_size - kernel_size // 2).to(logits.dtype).view(1, -1, 1, 1)
    gy = (idx // kernel_size - kernel_size // 2).to(logits.dtype).view(1, -1, 1, 1)
    h, w = logits.shape[2:]
    return torch.stack([(prob * gx).sum(1) / w * 2.0, (prob * gy).sum(1) / h * 2.0], dim=-1)


def kaiming_std(shape):
    """kaiming_normal_(mode='fan_out', nonlinearity='relu')."""
    return math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
