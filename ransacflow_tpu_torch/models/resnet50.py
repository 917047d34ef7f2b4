"""ResNet-50 trunk through layer3 (1024 channels, stride 16): the coarse
feature extractor (port of `ransacflow_tpu/models/resnet50.py:109-175`).

torchvision's `resnet50` names, so torchvision and MoCo checkpoints load
after `layer4.` and `fc.` are dropped (`models/convert.py`).

Frozen (eval mode, no grad, fp32: `layers.FrozenBNFold`), the stem and each
`Bottleneck` run with their BatchNorm folded into the convolutions, on a
card in NCHW (cuDNN's fp32 kernels compute in NCHW: a channels-last
activation pays a transpose each way around every convolution), and each
convolution's bias, shortcut and ReLU in one pass of kernel 14
(`kernels/conv_epilogue`): 40 launches a trunk pass. The downsample's
BatchNorm folds into its convolution and its bias joins conv3's, so the
downsample needs no pass of its own.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ransacflow_tpu_torch.kernels.conv_epilogue import conv_epilogue
from ransacflow_tpu_torch.models.layers import BatchNorm2d, FrozenBNFold, conv, nchw, nhwc

LAYERS = (("layer1", 3, 64, 1), ("layer2", 4, 128, 2), ("layer3", 6, 256, 2))
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _frozen_layout(x):
    """The frozen forward's input as it computes: fp32 and, on a card,
    contiguous NCHW, the layout of cuDNN's fp32 convolutions and of kernel
    14. On the CPU it keeps the caller's layout: oneDNN sums every cell of a
    channels-last map in one order, so cells that see the same pixels keep
    the same bits, as the unfolded forward keeps them (NCHW breaks the
    exact ties between scales of blocky scenes by position)."""
    x = x.float()
    return x.contiguous() if x.is_cuda else x


class Bottleneck(FrozenBNFold):
    """ResNet v1.5 bottleneck (stride on conv2, which may be dilated),
    expansion 4."""

    def __init__(self, cin, planes, stride, dilation=1):
        super().__init__()
        self.conv1 = conv(cin, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3, stride, dilation, dilation)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = None
        if stride != 1 or cin != planes * 4:
            self.downsample = nn.Sequential(conv(cin, planes * 4, 1, stride),
                                            BatchNorm2d(planes * 4))

    def _fold_pairs(self):
        pairs = [(self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3)]
        if self.downsample is not None:
            pairs.append(tuple(self.downsample))
        return pairs

    def _make_fold(self, folded):
        (w1, b1), (w2, b2), (w3, b3) = folded[:3]
        wd = ds_stride = None
        if self.downsample is not None:
            wd, bd = folded[3]
            b3 = b3 + bd  # one rounding of the summed bias
            ds_stride = self.downsample[0].stride
        c2 = self.conv2
        return (w1, b1.float(), w2, b2.float(), (c2.stride, c2.padding, c2.dilation),
                w3, b3.float(), wd, ds_stride)

    def forward(self, x):
        fold = self.frozen_fold()
        if fold is not None:
            return self._frozen_forward(x, fold)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)

    @staticmethod
    def _frozen_forward(x, fold):
        w1, b1, w2, b2, conv2_args, w3, b3, wd, ds_stride = fold
        x = _frozen_layout(x)
        out = conv_epilogue(F.conv2d(x, w1), b1)
        out = conv_epilogue(F.conv2d(out, w2, None, *conv2_args), b2)
        res = x if wd is None else F.conv2d(x, wd, None, ds_stride)
        return conv_epilogue(F.conv2d(out, w3), b3, res)


class ResNet50Layer3(FrozenBNFold):
    def __init__(self):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2, 3)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for name, blocks, planes, stride in LAYERS:
            mods = [Bottleneck(inplanes, planes, stride)]
            mods += [Bottleneck(planes * 4, planes, 1) for _ in range(blocks - 1)]
            setattr(self, name, nn.Sequential(*mods))
            inplanes = planes * 4

    def _fold_pairs(self):
        return [(self.conv1, self.bn1)]

    def _make_fold(self, folded):
        (w, b), = folded
        c = self.conv1
        return w, b.float(), (c.stride, c.padding)

    def forward(self, x):
        fold = self.frozen_fold()
        if fold is None:
            x = F.relu(self.bn1(self.conv1(x)))
        else:
            w, b, conv1_args = fold
            x = conv_epilogue(F.conv2d(_frozen_layout(x), w, None, *conv1_args), b)
        x = F.max_pool2d(x, 3, 2, 1)
        return self.layer3(self.layer2(self.layer1(x)))


def resnet50_layer3(net, x):
    """(B, H, W, 3) ImageNet-normalized images -> (B, H/16, W/16, 1024).
    The frozen trunk on a card computes in NCHW (it takes its input
    contiguous), any other in the channels-last memory of this view."""
    return nhwc(net(nchw(x)))


def imagenet_preprocess(x):
    """(B, H, W, 3) images in [0, 1] -> ImageNet-normalized.

    One channel at a time with Python scalars: a constant tensor would be a
    host-to-device copy, which waits for the stream, on every call.
    """
    return torch.stack([(x[..., c] - m) / s for c, (m, s) in
                        enumerate(zip(IMAGENET_MEAN, IMAGENET_STD))], dim=-1)
