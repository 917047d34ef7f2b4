"""Plain reference of stage 3 of RANSAC-Flow's training curriculum (the
reference's `train/stage3.sh`: flow + matchability, mu 1.0, lambda 0.01,
gradient weight 0, Adam 2e-4 with betas (0.5, 0.999)), in plain PyTorch
with its own autograd, written from the published method (Shen et al.,
ECCV 2020, section 3.3) and the reference implementation's losses.

A batch is I = concat(I1, I2) of 2B images; image i is paired with image
(i + B) mod 2B. The fine feature extractor (train-mode BatchNorm) gives
L2-normalized features f; corr = correlation(f[roll], f); the flow head's
softmax expectation, upsampled x8, plus the identity grid and clipped to
[-1, 1], is the sampling grid `final`; the matchability head's sigmoid,
upsampled x8, times the central-square margin mask, is `match`. With
match_cycle = sample(match[roll], final) * match:
  loss_cycle = sum(|sample(final[roll], final) - grid| mean over xy *
               match_cycle) / (sum(match_cycle) + 1e-3)
  loss_lr    = masked SSIM of sample(I, final) against I[roll] under the
               mask box11(match_cycle) > 0.5 (11x11 Gaussian window,
               sigma 1.5, C1 = 0.01^2, C2 = 0.03^2), summed / sum(mask) / 3
  loss_match = sum(|1 - match_cycle| * margin) / (sum(margin) + 1e-3)
  total      = loss_lr + mu loss_cycle + lambda loss_match
It imports nothing of the program.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import nets

NETS = ("netFeatCoarse", "netFlowCoarse", "netMatch")
SSIM_WINDOW, SSIM_SIGMA = 11, 1.5
C1, C2 = 0.01 ** 2, 0.03 ** 2


def identity_grid(h, w, device):
    xs = torch.linspace(-1.0, 1.0, w, device=device)
    ys = torch.linspace(-1.0, 1.0, h, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)[None]


def margin_mask(n, size, margin, device):
    m = torch.zeros(n, size, size, 1, device=device)
    m[:, margin:size - margin, margin:size - margin] = 1.0
    return m


def sample(img, grid):
    return F.grid_sample(img.permute(0, 3, 1, 2), grid, mode="bilinear",
                         padding_mode="zeros", align_corners=True).permute(0, 2, 3, 1)


def up8(x_nhwc):
    h, w = x_nhwc.shape[1:3]
    return F.interpolate(x_nhwc.permute(0, 3, 1, 2), size=(8 * h, 8 * w), mode="bilinear",
                         align_corners=True).permute(0, 2, 3, 1)


def _sep_blur(x, taps):
    """Depthwise separable 'same' convolution with zero padding, (B, H, W, C)."""
    c, k = x.shape[-1], len(taps)
    t = torch.tensor(taps, dtype=x.dtype, device=x.device)
    y = x.permute(0, 3, 1, 2)
    y = F.conv2d(y, t.view(1, 1, k, 1).expand(c, 1, k, 1), padding=(k // 2, 0), groups=c)
    y = F.conv2d(y, t.view(1, 1, 1, k).expand(c, 1, 1, k), padding=(0, k // 2), groups=c)
    return y.permute(0, 2, 3, 1)


def masked_ssim_loss(img1, img2, match):
    g = np.array([math.exp(-((i - SSIM_WINDOW // 2) ** 2) / (2.0 * SSIM_SIGMA ** 2))
                  for i in range(SSIM_WINDOW)])
    g = (g / g.sum()).tolist()
    box = [1.0 / SSIM_WINDOW] * SSIM_WINDOW
    with torch.no_grad():
        mask = _sep_blur(match, box) + 1e-7
        mask = (mask > 0.5).to(img1.dtype) + 1e-7
    mu1, mu2 = _sep_blur(img1, g), _sep_blur(img2, g)
    e11, e22, e12 = _sep_blur(img1 * img1, g), _sep_blur(img2 * img2, g), _sep_blur(img1 * img2, g)
    s1, s2, s12 = e11 - mu1 * mu1, e22 - mu2 * mu2, e12 - mu1 * mu2
    ssim = ((2 * mu1 * mu2 + C1) * (2 * s12 + C2)) / ((mu1 * mu1 + mu2 * mu2 + C1) * (s1 + s2 + C2))
    return ((1.0 - ssim) * mask).sum() / mask.sum() / 3.0


def losses(params, images, margin, mu_cycle, lambda_match, kernel_size, mm="exact"):
    """The stage-3 total loss and its terms for a (2B, H, W, 3) batch."""
    n, size = images.shape[0], images.shape[1]
    roll = torch.roll(torch.arange(n, device=images.device), n // 2)
    grid = identity_grid(size, size, images.device)
    mmask = margin_mask(n, size, margin, images.device)
    f = nets.l2_normalize(nets.feature_extractor(params["netFeatCoarse"],
                                                 images.permute(0, 3, 1, 2), True, mm), dim=1)
    fr, fl = (nets.round_tf32(f[roll]), nets.round_tf32(f)) if mm == "tf32" else (f[roll], f)
    corr = nets.correlation(fr, fl, kernel_size)
    flow = up8(nets.flow_epilogue(nets.head(params["netFlowCoarse"], corr, True, mm),
                                  kernel_size))
    final = torch.minimum(torch.maximum(flow + grid, torch.full((), -1.0, device=f.device)),
                          torch.full((), 1.0, device=f.device))
    match = up8(torch.sigmoid(nets.head(params["netMatch"], corr, True, mm))
                .permute(0, 2, 3, 1)) * mmask
    match_cycle = sample(match[roll], final) * match
    cycle_map = (sample(final[roll], final) - grid).abs().mean(dim=-1, keepdim=True)
    loss_cycle = (cycle_map * match_cycle).sum() / (match_cycle.sum() + 0.001)
    loss_lr = masked_ssim_loss(sample(images, final), images[roll], match_cycle)
    loss_match = ((1.0 - match_cycle).abs() * mmask).sum() / (mmask.sum() + 0.001)
    total = loss_lr + mu_cycle * loss_cycle + lambda_match * loss_match
    return total, {"loss_lr": loss_lr, "loss_cycle": loss_cycle, "loss_match": loss_match}


class Adam:
    """torch.optim.Adam's update (lr, betas, eps, no weight decay), written
    out: m, v moments, bias-corrected step."""

    def __init__(self, leaves, lr, betas, eps):
        self.leaves, self.lr, self.betas, self.eps, self.t = leaves, lr, betas, eps, 0
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, m, v in zip(self.leaves, self.m, self.v):
            g = p.grad
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(bc2)).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / bc1)


def trainable_keys(params):
    """(net, key) of every trained leaf: the convolutions and BatchNorm's
    weight and bias, in the networks' order."""
    return [(n, k) for n in NETS for k in params[n]
            if not k.endswith(("running_mean", "running_var"))]


def run_steps(params, batches, settings, mm="exact"):
    """Runs len(batches) Adam steps from `params` (copied first). Returns
    (losses [float], first gradients {(net, key): tensor}, changes
    {(net, key): tensor} after the last step)."""
    p = {n: {k: v.detach().clone() for k, v in params[n].items()} for n in NETS}
    keys = trainable_keys(p)
    leaves = [p[n][k].requires_grad_(True) for n, k in keys]
    opt = Adam(leaves, settings["lr"], tuple(settings["betas"]), settings["eps"])
    losses_, first_grads = [], None
    for images in batches:
        for leaf in leaves:
            leaf.grad = None
        total, _ = losses(p, images, settings["margin"], settings["mu_cycle"],
                          settings["lambda_match"], settings["kernel_size"], mm)
        total.backward()
        if first_grads is None:
            first_grads = {key: leaf.grad.detach().clone() for key, leaf in zip(keys, leaves)}
        opt.step()
        losses_.append(float(total.detach()))
    changes = {(n, k): (p[n][k].detach() - params[n][k]) for n, k in keys}
    return losses_, first_grads, changes
