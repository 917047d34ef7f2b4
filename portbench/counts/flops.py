"""Analytic FLOP counts of the alignment pipeline and of a training step,
the MFU's numerator, and the H100's dense peaks, its denominator.

A frozen copy of the program's `ransacflow_tpu_torch/utils/flops.py` (the
counts of `fused_align_flops` and its parts, copied as they were), so that
a later change to the program cannot move the yardstick, plus
`train_step_flops`, which the program lacks.

Counts are multiply-add FLOPs (2 * MACs) of every matmul- or conv-shaped
op: the ResNet-50 trunk through layer3, the fine feature extractor, the
local correlation volumes, the flow and matchability heads, the dense
matching product and the RANSAC solve and score. Gather-shaped ops
(grid_sample, bilinear upsampling, draws) count 0.
"""

# NVIDIA H100 SXM5 80 GB data sheet, dense, at its 700 W power limit.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def _out(size, kernel, stride, pad):
    """torch conv/pool output-size formula (floor)."""
    return (size + 2 * pad - kernel) // stride + 1


def conv_flops(h_out, w_out, cin, cout, kh=3, kw=3, groups=1):
    return 2 * h_out * w_out * cin * cout * kh * kw // groups


def resnet50_layer3_flops(h, w):
    """ResNet-50 conv1..layer3 (stride 16, 1024-ch) conv FLOPs at (h, w)."""
    total = 0
    h1, w1 = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    total += conv_flops(h1, w1, 3, 64, 7, 7)
    hp, wp = _out(h1, 3, 2, 1), _out(w1, 3, 2, 1)  # maxpool
    layers = [(3, 64, 1), (4, 128, 2), (6, 256, 2)]
    inplanes, hi, wi = 64, hp, wp
    for blocks, planes, stride in layers:
        for b in range(blocks):
            s = stride if b == 0 else 1
            cin = inplanes if b == 0 else planes * 4
            ho, wo = _out(hi, 3, s, 1), _out(wi, 3, s, 1)
            total += conv_flops(hi, wi, cin, planes, 1, 1)      # conv1 1x1
            total += conv_flops(ho, wo, planes, planes, 3, 3)   # conv2 3x3/s
            total += conv_flops(ho, wo, planes, planes * 4, 1, 1)  # conv3
            if b == 0:
                total += conv_flops(ho, wo, cin, planes * 4, 1, 1)  # downsample
            hi, wi = ho, wo
        inplanes = planes * 4
    return total


def feature_extractor_flops(h, w):
    """Fine feature net (stride 8, 256-ch) conv FLOPs at (h, w)."""
    total = conv_flops(h, w, 3, 64, 3, 3)                  # conv1 s1
    hm, wm = h - 1, w - 1                                  # maxpool k2 s1
    hi, wi = _out(hm + 2, 3, 2, 0), _out(wm + 2, 3, 2, 0)  # blurpool (reflect 1)
    total += conv_flops(hi, wi, 1, 1, 3, 3) * 64           # depthwise blur
    plan = [(64, 64, 1), (64, 128, 2), (128, 256, 2)]
    for cin, cout, stride in plan:
        for b in range(2):
            s = stride if b == 0 else 1
            ci = cin if b == 0 else cout
            ho, wo = _out(hi, 3, s, 1), _out(wi, 3, s, 1)
            total += conv_flops(ho, wo, ci, cout, 3, 3)    # conv1 (strided)
            total += conv_flops(ho, wo, cout, cout, 3, 3)  # conv2
            if b == 0 and (s != 1 or ci != cout):
                if s != 1:
                    total += conv_flops(ho, wo, 1, 1, 3, 3) * ci  # blurpool
                total += conv_flops(ho, wo, ci, cout, 1, 1)       # 1x1 proj
            hi, wi = ho, wo
    return total


def correlation_flops(h8, w8, channels=256, kernel_size=7):
    """One directional k^2-offset local correlation volume."""
    return 2 * h8 * w8 * channels * kernel_size * kernel_size


def head_flops(h8, w8, kernel_size=7, out_ch=None):
    """Flow/matchability head: k^2 -> 512 -> 256 -> 128 -> out, all 3x3."""
    k2 = kernel_size * kernel_size
    out_ch = k2 if out_ch is None else out_ch
    total = conv_flops(h8, w8, k2, 512)
    total += conv_flops(h8, w8, 512, 256)
    total += conv_flops(h8, w8, 256, 128)
    total += conv_flops(h8, w8, 128, out_ch)
    return total


def matching_flops(n_bank, n_target, channels=1024):
    """Dense mutual-matching score matmul (argmax passes are free)."""
    return 2 * n_bank * n_target * channels


def ransac_flops(n_matches, n_iter):
    """Vectorized RANSAC: closed-form DLT + matmul scoring.

    Scoring = three (N,3)@(3,n_iter) matmuls (x', y', w' reprojection,
    ops/ransac.py) -> 18*N*n_iter, plus ~8 elementwise ops per (match,
    hypothesis) cell for the dehomogenize/distance/threshold chain. The
    projective-basis DLT is ~1.5k FLOPs per hypothesis (3x3 matmuls +
    elementwise; ops/homography.py).
    """
    return 26 * n_matches * n_iter + 1500 * n_iter


def fused_align_flops(pyramid_shapes, target_hw, n_iter=10000,
                      kernel_size=7, stride=16):
    """Per-pair FLOPs of the fused serving program, per stage.

    Mirrors `pipeline.fused.fused_align`: trunk over the source pyramid +
    the target, one dense matching matmul, RANSAC, then the fine stage
    (2 feature-extractor forwards, 2 correlation volumes, 1 flow head,
    2 matchability heads — BOTH pred_flow_mask modes compute all of
    these; `cycle_match` only changes the final elementwise multiply,
    pipeline/fine.py:52-81, so it does not enter the count).
    Returns {stage: flops} plus 'total'.
    """
    ht, wt = target_hw
    trunk = sum(resnet50_layer3_flops(h, w) for h, w in pyramid_shapes)
    trunk += resnet50_layer3_flops(ht, wt)
    n_bank = sum((h // stride) * (w // stride) for h, w in pyramid_shapes)
    n_target = (ht // stride) * (wt // stride)
    match = matching_flops(n_bank, n_target)
    ransac = ransac_flops(n_target, n_iter)
    src_h, src_w = pyramid_shapes[len(pyramid_shapes) // 2]
    fine_feat = feature_extractor_flops(src_h, src_w)
    fine_feat += feature_extractor_flops(ht, wt)
    h8, w8 = ht // 8, wt // 8
    corr = 2 * correlation_flops(h8, w8, 256, kernel_size)
    heads = head_flops(h8, w8, kernel_size)          # flow
    heads += 2 * head_flops(h8, w8, kernel_size, 1)  # match12 + match21
    stages = {
        "trunk": trunk,
        "matching": match,
        "ransac": ransac,
        "fine_features": fine_feat,
        "correlation": corr,
        "heads": heads,
    }
    stages["total"] = sum(stages.values())
    return stages


def train_step_flops(pairs, img_size, kernel_size=7):
    """FLOPs of one training step of `pairs` pairs (2 * pairs images of
    img_size^2) in the flow + matchability mode: the forward of the fine
    feature extractor on every image, one correlation volume, the flow head
    and the matchability head at stride 8; the backward counted at twice
    the forward, less the first convolution's input gradient, which no
    step computes (the images are data)."""
    n = 2 * pairs
    h8 = img_size // 8
    fwd = (feature_extractor_flops(img_size, img_size)
           + correlation_flops(h8, h8, 256, kernel_size)
           + head_flops(h8, h8, kernel_size) + head_flops(h8, h8, kernel_size, 1))
    first_conv = conv_flops(img_size, img_size, 3, 64, 3, 3)
    return n * (3 * fwd - first_conv)
