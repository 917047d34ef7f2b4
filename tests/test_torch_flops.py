"""The port's FLOP model (`ransacflow_tpu_torch/utils/flops.py`) against the
JAX package's, and its table of peaks. The counts are integers: equal, not
close."""

import pytest
import torch

from ransacflow_tpu.utils import flops as jflops
from ransacflow_tpu_torch.utils import flops
from ransacflow_tpu_torch.utils.image import pyramid_shapes

SHAPES = [(480, 640), (224, 224), (375, 1242), (97, 131), (16, 16)]


@pytest.mark.parametrize("hw", SHAPES)
def test_network_counts_equal_jax(hw):
    h, w = hw
    assert flops.resnet50_layer3_flops(h, w) == jflops.resnet50_layer3_flops(h, w)
    assert flops.feature_extractor_flops(h, w) == jflops.feature_extractor_flops(h, w)
    for k in (3, 7):
        assert flops.correlation_flops(h // 8, w // 8, 256, k) == \
            jflops.correlation_flops(h // 8, w // 8, 256, k)
        assert flops.head_flops(h // 8, w // 8, k) == jflops.head_flops(h // 8, w // 8, k)
        assert flops.head_flops(h // 8, w // 8, k, 1) == \
            jflops.head_flops(h // 8, w // 8, k, 1)


@pytest.mark.parametrize("n_bank,n_target,n_iter", [(13065, 1200, 10000), (17, 5, 1),
                                                    (307200, 307200, 1000)])
def test_matching_and_ransac_counts_equal_jax(n_bank, n_target, n_iter):
    assert flops.matching_flops(n_bank, n_target) == jflops.matching_flops(n_bank, n_target)
    assert flops.ransac_flops(n_target, n_iter) == jflops.ransac_flops(n_target, n_iter)
    assert flops.conv_flops(7, 9, 12, 5, 3, 1, 1) == jflops.conv_flops(7, 9, 12, 5, 3, 1, 1)


@pytest.mark.parametrize("nb_scale,target", [(7, (480, 640)), (3, (240, 320)),
                                             (1, (160, 160))])
def test_fused_align_flops_equal_jax(nb_scale, target):
    shapes = pyramid_shapes(min_size=target[0], aspect=target, nb_scale=nb_scale)
    for kw in ({}, dict(n_iter=2000, kernel_size=5)):
        ours = flops.fused_align_flops(shapes, target, **kw)
        assert ours == jflops.fused_align_flops(shapes, target, **kw)
        assert ours["total"] == sum(v for k, v in ours.items() if k != "total")


def test_peak_table():
    """The H100 SXM5's dense peaks by compute dtype (NVIDIA's datasheet, 700
    W); None for another card or an unlisted dtype, so that no MFU is
    printed against a made-up peak."""
    name = "NVIDIA H100 80GB HBM3"
    assert flops.peak_flops(name, torch.float32) == 67e12
    assert flops.peak_flops(name, "float32") == 67e12
    assert flops.peak_flops(name, torch.bfloat16) == 989e12
    assert flops.peak_flops(name, "bfloat16") == 989e12
    assert flops.peak_flops(name, torch.float16) is None
    for other in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "cpu", ""):
        assert flops.peak_flops(other, torch.bfloat16) is None
