"""ADE20k scene-parsing network for sky removal (port of
`ransacflow_tpu/models/segnet.py`, the reference's segNet).

A ResNet-50 with a 3-conv stem whose layers 3 and 4 run at stride 1 with
dilation 2 and 4 (output stride 8), and a PPM decoder: adaptive average
pools at scales 1, 2, 3 and 6 (kernel 13, every scale in one launch), a
1x1 conv + BatchNorm + ReLU each, upsampled and concatenated with conv5,
then the conv head and a 150-class softmax at the requested size. Eval-mode
BatchNorm. The modules keep the reference's state_dict names.

`SkySegmenter` is the sky-mask protocol of segNet/segEval.py:23-43: five
scales (short side 300..600, long side <= 500, sizes rounded up to a
multiple of 8, PIL bilinear on the host), softmax scores averaged on the
device, argmax over classes, mask `pred == seg_id` (optionally inverted).
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from PIL import Image

from ransacflow_tpu_torch.device import as_device
from ransacflow_tpu_torch.kernels.adaptive_pool import ppm_pool
from ransacflow_tpu_torch.models.layers import conv, nchw
from ransacflow_tpu_torch.models.resnet50 import Bottleneck, imagenet_preprocess

LAYERS = (  # (name, blocks, planes, stride, dilation)
    ("layer1", 3, 64, 1, 1),
    ("layer2", 4, 128, 2, 1),
    ("layer3", 6, 256, 1, 2),
    ("layer4", 3, 512, 1, 4),
)
NUM_CLASSES = 150
POOL_SCALES = (1, 2, 3, 6)
FC_DIM = 2048


class SegNetEncoder(nn.Module):
    """Dilated ResNet-50: (B, 3, H, W) -> conv5 (B, 2048, H/8, W/8)."""

    def __init__(self):
        super().__init__()
        self.conv1 = conv(3, 64, 3, 2, 1)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = conv(64, 64, 3, 1, 1)
        self.bn2 = nn.BatchNorm2d(64)
        self.conv3 = conv(64, 128, 3, 1, 1)
        self.bn3 = nn.BatchNorm2d(128)
        inplanes = 128
        for name, blocks, planes, stride, dilation in LAYERS:
            # a dilated stage's first block: stride 1, conv2 dilated d/2
            # (segModel.py:186-199)
            first = dilation // 2 if dilation > 1 else 1
            mods = [Bottleneck(inplanes, planes, stride, first)]
            mods += [Bottleneck(planes * 4, planes, 1, dilation) for _ in range(blocks - 1)]
            setattr(self, name, nn.Sequential(*mods))
            inplanes = planes * 4

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


class PPMDecoder(nn.Module):
    """The PPM head. `ppm.{i}` is the reference's Sequential(pool, conv, BN,
    ReLU); its pool (index 0) is an identity here, because `forward` pools
    every scale in one kernel-13 launch."""

    def __init__(self):
        super().__init__()
        self.ppm = nn.ModuleList(
            nn.Sequential(nn.Identity(), conv(FC_DIM, 512, 1), nn.BatchNorm2d(512), nn.ReLU())
            for _ in POOL_SCALES)
        self.conv_last = nn.Sequential(
            conv(FC_DIM + len(POOL_SCALES) * 512, 512, 3, 1, 1), nn.BatchNorm2d(512),
            nn.ReLU(), nn.Dropout2d(0.1), nn.Conv2d(512, NUM_CLASSES, 1))

    def forward(self, conv5, seg_size):
        """conv5 (B, H, W, 2048) -> class softmax (B, h, w, 150) at seg_size."""
        _, H, W, _ = conv5.shape
        outs = [conv5]
        for stage, pooled in zip(self.ppm, ppm_pool(conv5, POOL_SCALES)):
            y = stage[1:](nchw(pooled))
            outs.append(F.interpolate(y, size=(H, W), mode="bilinear",
                                      align_corners=False).permute(0, 2, 3, 1))
        x = self.conv_last(nchw(torch.cat(outs, dim=-1)))
        x = F.interpolate(x, size=tuple(seg_size), mode="bilinear", align_corners=False)
        return torch.softmax(x, dim=1).permute(0, 2, 3, 1)


def segnet_encoder(net, x):
    """(B, H, W, 3) ImageNet-normalized -> conv5 (B, H/8, W/8, 2048),
    contiguous. The stem keeps the input's channels-last memory; frozen on
    a card the blocks compute in NCHW (`models/resnet50.Bottleneck`), and
    the last permute copies."""
    return net(nchw(x)).permute(0, 2, 3, 1).contiguous()


def segnet_decoder(net, conv5, seg_size):
    """The `PPMDecoder` `net` on conv5 (B, H, W, 2048) -> per-class softmax
    (B, h, w, 150) at seg_size (h, w)."""
    return net(conv5, seg_size)


def _round_up(x, p):
    return ((x - 1) // p + 1) * p


class SkySegmenter:
    """Multi-scale sky-mask inference (segNet/segEval.py API mirror).

    Args:
      encoder, decoder: `SegNetEncoder` and `PPMDecoder` on `device`, in eval
        mode (`models.convert.init_segnet`, `load_segnet`, `segnet_from_tree`).
      device: the device the networks run on.
      seg_id: ADE20k class index (2 = sky in the eval harnesses).
      seg_fg: invert the mask (1 - (pred == seg_id)).
    """

    IMG_SIZES = (300, 375, 450, 525, 600)
    IMG_MAX_SIZE = 500
    PADDING = 8

    def __init__(self, encoder, decoder, device, seg_id=2, seg_fg=False):
        self.encoder = encoder
        self.decoder = decoder
        self.device = as_device(device)
        self.seg_id = seg_id
        self.seg_fg = seg_fg

    @torch.inference_mode()
    def class_scores(self, img):
        """PIL image -> (H, W, 150) softmax scores averaged over the scales,
        summed on the device in the scales' order."""
        w, h = img.size
        scores = torch.zeros((h, w, NUM_CLASSES), device=self.device)
        for short in self.IMG_SIZES:
            scale = min(short / float(min(h, w)), self.IMG_MAX_SIZE / float(max(h, w)))
            tw = _round_up(int(w * scale), self.PADDING)
            th = _round_up(int(h * scale), self.PADDING)
            arr = np.asarray(img.resize((tw, th), resample=Image.BILINEAR), np.float32) / 255.0
            x = imagenet_preprocess(torch.from_numpy(arr).to(self.device)[None])
            pred = self.decoder(segnet_encoder(self.encoder, x), (h, w))
            scores += pred[0] / len(self.IMG_SIZES)
        return scores

    def get_sky(self, img):
        """PIL image (or path) -> float32 (H, W) mask of `seg_id` pixels; only
        the mask is read back from the device."""
        if isinstance(img, str):
            img = Image.open(img).convert("RGB")
        pred = torch.argmax(self.class_scores(img), dim=-1)
        mask = (pred == self.seg_id).to(torch.float32).cpu().numpy()
        return 1.0 - mask if self.seg_fg else mask
