"""Self-supervised training losses (port of `ransacflow_tpu/train/losses.py`).

A batch is ``I = concat(I1, I2)`` of 2B images; ``index_roll`` pairs image i
with its counterpart, so both flow directions come from one forward pass.
The three loss modes of the reference's curriculum:

- 'flow'       (stages 1-2): SSIM reconstruction + cycle consistency.
- 'flow+match' (stage 3): matchability-weighted SSIM and cycle terms, the
               matchability and flow-gradient terms.
- 'grad'       (visuals fine-tune): as 'flow+match', only the flow net
               trains.

A network outside the mode's trained set runs in eval mode under
`torch.no_grad()`: the reference's stop_gradient with eval BatchNorm. On
CUDA tensors the losses run through hand kernels with kernel backwards:
correlation (K6), head epilogues (K7), blur-pool (K9, in the feature
extractor), masked SSIM (K10) and `grid_sample` (K5 forward, K11 backward).

`compute_dtype` is the reference's mixed-precision policy
(`models.layers.cast_compute_params`): bf16 convolutions from fp32 masters,
fp32 BatchNorm, so the features are fp32 and only the heads' last
convolution gives bf16 (K7 takes bf16 logits); the flow and matchability
become fp32 where the reference casts them (`ransacflow_tpu/train/
losses.py:121`). `remat` recomputes the feature trunk in the backward
(`torch.utils.checkpoint`, the reference's `jax.checkpoint`).
"""

import torch
from torch.utils.checkpoint import checkpoint

from ransacflow_tpu_torch.kernels.correlation import correlation_volume
from ransacflow_tpu_torch.kernels.ssim import masked_ssim_loss
from ransacflow_tpu_torch.kernels.warp_sample import warp_sample as grid_sample
from ransacflow_tpu_torch.models.feature_extractor import feature_extractor
from ransacflow_tpu_torch.models.heads import (
    flow_gradient_magnitude,
    flow_to_grid,
    net_flow_coarse,
    net_matchability,
)
from ransacflow_tpu_torch.models.layers import (
    cast_compute_params,
    frozen_bn_stats,
    l2_normalize,
    synced_batch_norm,
)
from ransacflow_tpu_torch.parallel.group import all_reduce_sum, world_size

TRAIN_MODULES = {
    "flow": ("netFeatCoarse", "netFlowCoarse"),
    "flow+match": ("netFeatCoarse", "netFlowCoarse", "netMatch"),
    "grad": ("netFlowCoarse",),
}


def margin_mask(batch2, img_size, margin, device, dtype=torch.float32):
    """(2B, H, W, 1) ones on the central square, zero border."""
    m = torch.zeros((batch2, img_size, img_size, 1), dtype=dtype, device=device)
    m[:, margin:img_size - margin, margin:img_size - margin] = 1.0
    return m


def _ratio(num, den, group=None):
    """sum(num) / (sum(den) + 0.001); with `group`, both sums over its ranks
    (one all-reduce), the global ratio of the reference's `axis_name`."""
    if world_size(group) == 1:
        return num.sum() / (den.sum() + 0.001)
    sums = all_reduce_sum(torch.stack([num.sum(), den.sum()]), group)
    return sums[0] / (sums[1] + 0.001)


def _rematerialized(compute_dtype, group=None):
    """The feature trunk under `checkpoint`: its activations are recomputed
    in the backward, not kept. The recompute runs under the same compute
    dtype (the backward runs outside `compute_losses`' policy block) and
    normalizes with the batch's moments again, but leaves the running
    statistics alone, so that they move once, as in the plain step
    (`jax.checkpoint` is pure). Under `group` the recompute takes the
    global moments again, with the same all-reduces on every rank."""
    def trunk_of(net, images):
        runs = []

        def trunk(x):
            with cast_compute_params([net], compute_dtype), \
                    synced_batch_norm([net], group), \
                    frozen_bn_stats(net, frozen=bool(runs)):
                runs.append(1)
                return feature_extractor(net, x)

        return checkpoint(trunk, images, use_reentrant=False)

    return trunk_of


def compute_losses(nets, images, index_roll, grid, mask_margin, mode="flow",
                   mu_cycle=1.0, lambda_match=0.01, grad_weight=0.0, kernel_size=7,
                   compute_dtype=None, remat=False, group=None):
    """Returns (total_loss, dict of the four loss terms).

    nets: dict of the alignment networks ('netFeatCoarse', 'netFlowCoarse',
      'netMatch'); each is put in train or eval mode here, and the trained
      ones update their BatchNorm running statistics.
    images: (2B, H, W, 3) in [0, 1]; index_roll: (2B,) permutation pairing
      each image with its counterpart; grid: (1, H, W, 2) identity grid;
      mask_margin: (2B, H, W, 1) central-crop supervision mask.
    compute_dtype: None (fp32) or the convolutions' dtype (torch.bfloat16 or
      'bfloat16') under the mixed-precision policy; remat: recompute the
      feature trunk in the backward.
    group: a process group for data parallelism (`parallel.group`): this
      rank's images are its share of the global batch, every ratio and
      the trained networks' BatchNorm moments are global over the ranks
      (the reference's `axis_name`), and the losses are the global batch's.
    """
    trunk = _rematerialized(compute_dtype, group) if remat else feature_extractor
    with cast_compute_params(nets.values(), compute_dtype), \
            synced_batch_norm(nets.values(), group):
        return _losses(nets, trunk, images, index_roll, grid, mask_margin, mode,
                       mu_cycle, lambda_match, grad_weight, kernel_size, group)


def _losses(nets, trunk, images, index_roll, grid, mask_margin, mode, mu_cycle,
            lambda_match, grad_weight, kernel_size, group):
    trained = TRAIN_MODULES[mode]
    with_match = mode in ("flow+match", "grad")

    def run(name, fn, *args):
        net = nets[name]
        net.train(name in trained)
        if name in trained:
            return fn(net, *args)
        with torch.no_grad():
            return fn(net, *args)

    f = l2_normalize(run("netFeatCoarse", trunk, images))
    corr = correlation_volume(f[index_roll], f, kernel_size)
    flow = run("netFlowCoarse", net_flow_coarse, corr, True, kernel_size).float()
    flow_grad = flow_gradient_magnitude(flow)  # (2B, H-1, W-1, 1)
    final = flow_to_grid(flow, grid)           # (2B, H, W, 2)

    if with_match:
        match = run("netMatch", net_matchability, corr, True).float() * mask_margin
        match_cycle = grid_sample(match[index_roll], final) * match
        cycle_weight = recon_mask = match_cycle
    else:
        cycle_weight = recon_mask = mask_margin

    # cycle consistency: warping forward then backward must return to grid
    flow_c = grid_sample(final[index_roll], final)
    cycle_map = (flow_c - grid).abs().mean(dim=-1, keepdim=True)
    loss_cycle = _ratio(cycle_map * cycle_weight, cycle_weight, group)

    # masked SSIM reconstruction
    warped = grid_sample(images, final)
    loss_lr = masked_ssim_loss(warped, images[index_roll], recon_mask, group)

    total = loss_lr + mu_cycle * loss_cycle
    if with_match:
        loss_match = _ratio((1.0 - match_cycle).abs() * mask_margin, mask_margin, group)
        w = (1.0 - match_cycle[:, :-1, :-1, :]) * mask_margin[:, :-1, :-1, :]
        loss_grad = _ratio(flow_grad * w, w, group)
        total = total + lambda_match * loss_match + grad_weight * loss_grad
    else:
        # 'flow' mode has neither matchability nor gradient terms
        loss_match = loss_grad = torch.zeros((), device=images.device)
    return total, {"loss_lr": loss_lr, "loss_cycle": loss_cycle,
                   "loss_match": loss_match, "loss_grad": loss_grad}
