"""ResNet-50 trunk through layer3 (1024 channels, stride 16): the coarse
feature extractor (port of `ransacflow_tpu/models/resnet50.py:109-175`).

torchvision's `resnet50` names, so torchvision and MoCo checkpoints load
after `layer4.` and `fc.` are dropped (`models/convert.py`).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ransacflow_tpu_torch.models.layers import conv, nchw, nhwc

LAYERS = (("layer1", 3, 64, 1), ("layer2", 4, 128, 2), ("layer3", 6, 256, 2))
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Bottleneck(nn.Module):
    """ResNet v1.5 bottleneck (stride on conv2, which may be dilated),
    expansion 4."""

    def __init__(self, cin, planes, stride, dilation=1):
        super().__init__()
        self.conv1 = conv(cin, planes, 1)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3, stride, dilation, dilation)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = None
        if stride != 1 or cin != planes * 4:
            self.downsample = nn.Sequential(conv(cin, planes * 4, 1, stride),
                                            nn.BatchNorm2d(planes * 4))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class ResNet50Layer3(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2, 3)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for name, blocks, planes, stride in LAYERS:
            mods = [Bottleneck(inplanes, planes, stride)]
            mods += [Bottleneck(planes * 4, planes, 1) for _ in range(blocks - 1)]
            setattr(self, name, nn.Sequential(*mods))
            inplanes = planes * 4

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        return self.layer3(self.layer2(self.layer1(x)))


def resnet50_layer3(net, x):
    """(B, H, W, 3) ImageNet-normalized images -> (B, H/16, W/16, 1024)."""
    return nhwc(net(nchw(x)))


def imagenet_preprocess(x):
    """(B, H, W, 3) images in [0, 1] -> ImageNet-normalized.

    One channel at a time with Python scalars: a constant tensor would be a
    host-to-device copy, which waits for the stream, on every call.
    """
    return torch.stack([(x[..., c] - m) / s for c, (m, s) in
                        enumerate(zip(IMAGENET_MEAN, IMAGENET_STD))], dim=-1)
