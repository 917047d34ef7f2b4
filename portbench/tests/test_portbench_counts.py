"""The frozen FLOP and byte counts against values worked by hand."""

import pytest

from portbench.counts import flops, roofline
from portbench.drivers.align import pyramid_shapes


def test_conv_correlation_and_head_counts():
    # 2 * 4 * 4 outputs * 2 in * 3 out * 9 taps
    assert flops.conv_flops(4, 4, 2, 3) == 1728
    # 2 * 2 * 3 cells * 4 channels * 9 offsets
    assert flops.correlation_flops(2, 3, 4, 3) == 432
    # a head at one cell, k = 3: 9 -> 512 -> 256 -> 128 -> 9, all 3x3
    hand = 2 * 9 * (9 * 512 + 512 * 256 + 256 * 128 + 128 * 9)
    assert flops.head_flops(1, 1, 3) == hand == 3052800


def test_trunk_stem_and_serving_total():
    # the stem alone at 32x32: conv1 7x7/2 -> 16x16 x 64, from 3 channels
    stem = 2 * 16 * 16 * 3 * 64 * 49
    assert flops.conv_flops(16, 16, 3, 64, 7, 7) == stem
    shapes = pyramid_shapes(480, (480, 640), 7, 2.0)
    assert shapes == [(960, 1280), (800, 1056), (640, 848), (480, 640), (400, 528),
                      (320, 416), (240, 320)]
    # the program's count (utils/flops.fused_align_flops) when it was frozen
    assert flops.fused_align_flops(shapes, (480, 640))["total"] == 687541141440


def test_train_step_count():
    n, h8 = 2, 2
    fwd = (flops.feature_extractor_flops(16, 16) + flops.correlation_flops(h8, h8)
           + flops.head_flops(h8, h8) + flops.head_flops(h8, h8, out_ch=1))
    assert flops.train_step_flops(1, 16) == n * (3 * fwd - flops.conv_flops(16, 16, 3, 64))
    assert flops.train_step_flops(16, 224) == 1521965727744


def test_roofline_rule():
    assert roofline.bound_s(3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 67e12) == pytest.approx(1.0)
    # blur-pool shapes at 224: (223 + 2 - 3) // 2 + 1 = 112, then 56 and 28
    assert roofline.blur_shapes(224, 224) == [((64, 223, 223), (112, 112)),
                                              ((64, 112, 112), (56, 56)),
                                              ((128, 56, 56), (28, 28))]
    # masked SSIM of one pair of 8x8 images: 7 floats in a pixel; a channel's
    # five blurred maps of two 11-tap passes (220 operations), 3 channels,
    # and the 44 of the mask's box a pixel
    px = 2 * 8 * 8
    want = max(4 * px * 7 / 3.35e12, px * (3 * 220 + 44) / 67e12)
    assert roofline.train_bounds(1, 8)["masked_ssim"] == pytest.approx(want)
    assert roofline.is_hand_kernel("void correlation_kernel<7, true>(float const*)")
    assert roofline.is_hand_kernel("pyramid_kernel")
    assert not roofline.is_hand_kernel("sm80_xmma_fprop_implicit_gemm_f32f32")
    assert not roofline.is_hand_kernel("my_pyramid_kernel2")
