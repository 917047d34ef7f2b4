"""Fine-stage feature extractor (256 channels, stride 8), port of
`ransacflow_tpu/models/feature_extractor.py:64-123`.

conv3x3(3->64) -> BN -> ReLU -> [MaxPool(2, 1) -> blur-pool(3, 2)] -> layer1
(2 BasicBlocks, 64) -> layer2 (128, s2) -> layer3 (256, s2), with blur-pooled
downsample shortcuts. `state_dict` names are the reference's
(`layer2.0.downsample.1.weight`, ...).

Frozen (eval mode, no grad, fp32: `layers.FrozenBNFold`), the stem and each
`BasicBlock` fold their BatchNorm into the convolutions and compute in NHWC,
each convolution one launch of kernel 15 (`kernels/fine_conv`) with its
bias, shortcut and ReLU: 15 launches a pass. The downsample's BatchNorm
folds into its 1x1 convolution and its bias joins the block's second
convolution's, so the downsample ends in a plain store. Anything else runs
the unfolded forward on cuDNN.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ransacflow_tpu_torch.kernels.fine_conv import fine_conv, pack_folded
from ransacflow_tpu_torch.models.layers import BatchNorm2d, FrozenBNFold, conv, nchw, nhwc
from ransacflow_tpu_torch.ops.blurpool import BlurPool

LAYER_PLAN = (("layer1", 64, 64, 1), ("layer2", 64, 128, 2), ("layer3", 128, 256, 2))


class BasicBlock(FrozenBNFold):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv1 = conv(cin, cout, 3, stride, 1)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = conv(cout, cout, 3, 1, 1)
        self.bn2 = BatchNorm2d(cout)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(BlurPool(cin, 3, stride),
                                            conv(cin, cout, 1),
                                            BatchNorm2d(cout))

    def _fold_pairs(self):
        pairs = [(self.conv1, self.bn1), (self.conv2, self.bn2)]
        if self.downsample is not None:
            pairs.append(tuple(self.downsample)[1:])
        return pairs

    def _make_fold(self, folded):
        (w1, b1), (w2, b2) = folded[:2]
        ds = None
        if self.downsample is not None:
            wd, bd = folded[2]
            b2 = b2 + bd  # one rounding of the summed bias
            ds = pack_folded(self.downsample[1], wd, None)
        return pack_folded(self.conv1, w1, b1), pack_folded(self.conv2, w2, b2), ds

    def forward(self, x):
        fold = self.frozen_fold()
        if fold is not None:  # NHWC in and out, as NCHW views of channels-last memory
            c1, c2, ds = fold
            x = nhwc(x)
            res = x if ds is None else fine_conv(nhwc(self.downsample[0](nchw(x))), ds)
            return nchw(fine_conv(fine_conv(x, c1), c2, res))
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class FeatureExtractor(FrozenBNFold):
    def __init__(self):
        super().__init__()
        self.conv1 = conv(3, 64, 3, 1, 1)
        self.bn1 = BatchNorm2d(64)
        self.blur = BlurPool(64, 3, 2)
        for name, cin, cout, stride in LAYER_PLAN:
            setattr(self, name, nn.Sequential(BasicBlock(cin, cout, stride),
                                              BasicBlock(cout, cout, 1)))

    def _fold_pairs(self):
        return [(self.conv1, self.bn1)]

    def _make_fold(self, folded):
        (w, b), = folded
        return pack_folded(self.conv1, w, b)

    def forward(self, x):
        fold = self.frozen_fold()
        if fold is not None:
            # NHWC throughout: kernel 15, then max pooling and kernel 9 on
            # channels-last memory, then the blocks
            x = self.blur(F.max_pool2d(nchw(fine_conv(nhwc(x), fold)), 2, 1))
            return self.layer3(self.layer2(self.layer1(x)))
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
