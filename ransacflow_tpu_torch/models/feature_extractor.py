"""Fine-stage feature extractor (256 channels, stride 8), port of
`ransacflow_tpu/models/feature_extractor.py:64-123`.

conv3x3(3->64) -> BN -> ReLU -> [MaxPool(2, 1) -> blur-pool(3, 2)] -> layer1
(2 BasicBlocks, 64) -> layer2 (128, s2) -> layer3 (256, s2), with blur-pooled
downsample shortcuts. `state_dict` names are the reference's
(`layer2.0.downsample.1.weight`, ...).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ransacflow_tpu_torch.models.layers import conv, nchw, nhwc
from ransacflow_tpu_torch.ops.blurpool import BlurPool

LAYER_PLAN = (("layer1", 64, 64, 1), ("layer2", 64, 128, 2), ("layer3", 128, 256, 2))


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv1 = conv(cin, cout, 3, stride, 1)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = conv(cout, cout, 3, 1, 1)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(BlurPool(cin, 3, stride),
                                            conv(cin, cout, 1),
                                            nn.BatchNorm2d(cout))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class FeatureExtractor(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = conv(3, 64, 3, 1, 1)
        self.bn1 = nn.BatchNorm2d(64)
        self.blur = BlurPool(64, 3, 2)
        for name, cin, cout, stride in LAYER_PLAN:
            setattr(self, name, nn.Sequential(BasicBlock(cin, cout, stride),
                                              BasicBlock(cout, cout, 1)))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.blur(F.max_pool2d(x, 2, 1))
        if not torch.is_grad_enabled():
            # The layers below run on cuDNN in the memory format they are
            # handed: channels-last (from conv1, kept by the blur-pool
            # kernel) is faster for a training step, NCHW for inference
            # (H100, fp32: a 224x224 batch-32 step 56.1 against 60.5 ms;
            # one 480x640 image 4.94 against 3.99 ms).
            x = x.contiguous()
        return self.layer3(self.layer2(self.layer1(x)))


def feature_extractor(net, x):
    """(B, H, W, 3) images in [0, 1] -> (B, H/8, W/8, 256)."""
    return nhwc(net(nchw(x)))
