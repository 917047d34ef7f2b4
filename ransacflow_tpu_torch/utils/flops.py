"""Analytic FLOP model of the alignment pipeline, for MFU reporting (the
port's copy of `ransacflow_tpu/utils/flops.py`: importing the JAX package
imports JAX).

Counts multiply-add FLOPs (2 * MACs) of every matmul/conv-shaped op in the
serving path — the ResNet-50 trunk (reference model/resnet50.py:107-193 /
torchvision, bottleneck [3,4,6]), the fine feature extractor
(model/model.py:59-125), the correlation volumes (model/model.py:129-160),
the flow/matchability heads (model/model.py:167-322), the dense mutual-
matching matmul (utils/outil.py:32-45), and the RANSAC solve+score program
(utils/outil.py:97-113). Gather-shaped ops (grid_sample, bilinear
upsampling, RANSAC minimal-set sampling) contribute ~0 FLOPs and are
deliberately NOT counted, so the reported MFU is a conventional model-FLOPs
utilization, honest about the fact that a large share of wall time is
non-matmul work.

All counters return plain Python ints. `peak_flops` maps a CUDA card's name
and the compute dtype to its dense peak, the MFU's denominator.
"""


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


# Dense peak FLOP/s (no sparsity) by card and compute dtype, from NVIDIA's
# H100 datasheet for the SXM5 80 GB part at its 700 W power limit; a card set
# to a lower limit runs below these under load. float32 is outside the tensor
# cores: the port turns TF32 off (`device.use_full_fp32`), and
# `chip_smoke.bound` uses the same figure.
_PEAK_FLOPS = (
    ("H100 80GB HBM3", {"float32": 67e12, "bfloat16": 989e12}),  # H100 SXM5 80 GB, 700 W
)


def peak_flops(device_name, dtype):
    """Dense peak FLOP/s of the card named `device_name`
    (`torch.cuda.get_device_name()`) computing in `dtype` (a torch dtype or
    its name), or None for a card or dtype the table lacks: the caller then
    prints no MFU rather than one against a made-up peak."""
    dtype = str(dtype).removeprefix("torch.")
    for tag, peaks in _PEAK_FLOPS:
        if tag in device_name:
            return peaks.get(dtype)
    return None
