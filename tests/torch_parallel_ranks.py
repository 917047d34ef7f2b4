"""What the ranks of `tests/test_torch_parallel.py` run, in a module of its
own: `parallel.spawn` pickles a rank's function by its import path, and a
spawned rank imports this module (torch and the port, not JAX)."""

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from ransacflow_tpu_torch.models.convert import alignment_params_from_tree
from ransacflow_tpu_torch.ops.grid import normalized_grid
from ransacflow_tpu_torch.train import (
    losses,
    fit,
    local_index_roll,
    make_optimizer,
    margin_mask,
    split_trainable,
    train_grads,
)

IMG, MARGIN, K = 32, 8, 7


def local_rows(n_global, rank, world):
    """The rows of a global batch concat(I1, I2) (n_global pairs) that rank
    `rank` holds as its concat(I1_r, I2_r)."""
    b = n_global // world
    rows = np.arange(rank * b, (rank + 1) * b)
    return np.concatenate([rows, n_global + rows])


def pinned_correlation(corr):
    """`losses.correlation_volume` with its value pinned to `corr` and its
    gradient still flowing into the features (tests/test_torch_train.py's
    `_shared_corr` says why)."""
    orig = losses.correlation_volume

    def pinned(x, y, k):
        c = orig(x, y, k)
        return torch.from_numpy(corr).to(c.device) + (c - c.detach())

    return pinned


def state(nets, mode):
    """(trainable gradients, BatchNorm buffers, parameters) as numpy, keyed
    'net.name'."""
    trained = split_trainable(nets, mode)[0]
    ids = {id(p) for p in trained}
    grads, bufs, params = {}, {}, {}
    for name, net in nets.items():
        for k, p in net.named_parameters():
            params[f"{name}.{k}"] = p.detach().cpu().numpy().copy()
            if id(p) in ids:
                grads[f"{name}.{k}"] = p.grad.cpu().numpy().copy()
        for k, b in net.named_buffers():
            bufs[f"{name}.{k}"] = b.cpu().numpy().copy()
    return grads, bufs, params


def step_case(trees, imgs, corr, case, device, group, rows=None):
    """One training step of `case` (the loss keywords, compute_dtype,
    remat, and `pinned`: the correlation volume pinned to `corr`) from the
    networks `trees`, on the batch `imgs` (the rows `rows` of it, under
    `group`). Returns {'metrics', 'grads', 'bn', 'params'}:
    the reduced gradients and the BatchNorm statistics before Adam's step,
    the parameters after it."""
    case = dict(case)
    pinned = case.pop("pinned")
    n_local = len(imgs) // 2 if rows is None else len(rows) // 2
    x = imgs if rows is None else imgs[rows]
    nets = alignment_params_from_tree(trees, device)
    opt = make_optimizer(split_trainable(nets, case["mode"])[0])
    batch = (torch.from_numpy(np.ascontiguousarray(x)).to(device),
             local_index_roll(n_local, device), normalized_grid(IMG, IMG, device)[None],
             margin_mask(2 * n_local, IMG, MARGIN, device))
    orig = losses.correlation_volume
    if pinned:
        losses.correlation_volume = pinned_correlation(corr if rows is None else corr[rows])
    try:
        metrics = train_grads(nets, opt, *batch, kernel_size=K, group=group, **case)
    finally:
        losses.correlation_volume = orig
    grads, bn, _ = state(nets, case["mode"])
    opt.step()
    _, _, params = state(nets, case["mode"])
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads, "bn": bn,
            "params": params}


def dp_cases(rank, world, device, trees, imgs, corr, cases):
    """Each case of `step_case` on this rank's share of the global batch,
    data-parallel over the default group."""
    torch.set_num_threads(1)
    rows = local_rows(len(imgs) // 2, rank, world)
    return [step_case(trees, imgs, corr, case, device, dist.group.WORLD, rows)
            for case in cases]


def fit_rank(rank, world, device, trees, data, outs, kw):
    """`fit(n_devices=world)` on this rank, writing (if anything) to
    outs[rank]; returns its networks' state."""
    torch.set_num_threads(1)
    nets = alignment_params_from_tree(trees, device)
    if rank == 1:  # a replica that starts elsewhere: fit broadcasts rank 0's
        with torch.no_grad():
            for p in nets["netFlowCoarse"].parameters():
                p.add_(1.0)
    fit(nets, data, outs[rank], device, n_devices=world, **kw)
    return {f"{n}.{k}": v.cpu() for n, net in nets.items() for k, v in net.state_dict().items()}


def files_of(path):
    return sorted(os.listdir(path)) if os.path.isdir(path) else []


def read_metrics(out):
    return [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]


def synced_bn(rank, world, x, g, group):
    """The port's BatchNorm2d on this rank's rows of x under `group`, train
    mode: (y, dx for the cotangent g's rows, the weight and bias gradients
    summed over the ranks, the running statistics)."""
    from ransacflow_tpu_torch.models.layers import BatchNorm2d, synced_batch_norm

    b = len(x) // world
    rows = slice(rank * b, (rank + 1) * b)
    bn = BatchNorm2d(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, x.shape[1]))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, x.shape[1]))
    xl = torch.from_numpy(x[rows]).requires_grad_()
    with synced_batch_norm([bn], group):
        y = bn.train()(xl)
    y.backward(torch.from_numpy(g[rows]))
    dw = torch.stack([bn.weight.grad, bn.bias.grad])
    if group is not None:
        dist.all_reduce(dw, group=group)
    return {"y": y.detach().numpy(), "dx": xl.grad.numpy(), "dwb": dw.numpy(),
            "stats": torch.stack([bn.running_mean, bn.running_var]).numpy(),
            "count": int(bn.num_batches_tracked)}


def ssim_global(rank, world, img1, img2, match, group):
    """K10's global form (the plain twin on the CPU) on this rank's rows:
    (the loss, d loss / d img1 of this rank's backward)."""
    from ransacflow_tpu_torch.kernels.ssim import masked_ssim_loss

    b = len(img1) // world
    rows = slice(rank * b, (rank + 1) * b)
    i1 = torch.from_numpy(img1[rows]).requires_grad_()
    loss = masked_ssim_loss(i1, torch.from_numpy(img2[rows]), torch.from_numpy(match[rows]),
                            group)
    loss.backward()
    return float(loss), i1.grad.numpy()


def world2(rank, world, device, trees, imgs, corr, cases, bn, ssim):
    """What the world-2 group of the tests runs: `dp_cases`, the synced
    BatchNorm under the group and under a group of this rank alone, and
    K10's global form."""
    torch.set_num_threads(1)
    alone = [dist.new_group([r]) for r in range(world)][rank]
    return {"cases": dp_cases(rank, world, device, trees, imgs, corr, cases),
            "bn": synced_bn(rank, world, *bn, dist.group.WORLD),
            "bn_alone": synced_bn(0, 1, bn[0][:2], bn[1][:2], alone),
            "ssim": ssim_global(rank, world, *ssim, dist.group.WORLD)}


def _blocky(rng, h, w):
    from PIL import Image

    base = (rng.rand(h // 4, w // 4, 3) > 0.5).astype(np.float32)
    img = np.kron(base, np.ones((4, 4, 1), np.float32))[:h, :w]
    return Image.fromarray((img * 255).astype(np.uint8))


def dryrun(rank, world, device, trees):
    """The gloo twin of `__graft_entry__.dryrun_multichip`: the data-parallel
    stage-3 step on every rank (1 pair a rank), and on rank 0 the three
    layouts over `world` CPU slots: sharded RANSAC, the pooled batched eval
    and sharded serving with adaptive RANSAC. Returns what each checked."""
    from ransacflow_tpu_torch.eval.pooled import pooled_multihomo_predict
    from ransacflow_tpu_torch.models.convert import init_resnet50_layer3
    from ransacflow_tpu_torch.ops.homography import apply_homography
    from ransacflow_tpu_torch.parallel import sharded_align_pairs, sharded_ransac

    torch.set_num_threads(1)
    rng = np.random.RandomState(0)
    imgs = rng.rand(2 * world, IMG, IMG, 3).astype(np.float32)
    case = dict(mode="flow+match", mu_cycle=1.0, lambda_match=0.01, grad_weight=1.0,
                pinned=False)
    step = step_case(trees, imgs, None, case, device, dist.group.WORLD,
                     local_rows(world, rank, world))
    out = {"loss": step["metrics"]["loss"],
           "param_sum": float(sum(v.astype(np.float64).sum() for v in step["params"].values()))}
    if rank:
        return out
    slots = ["cpu"] * world
    n = 64
    m2 = torch.from_numpy(rng.rand(n, 2).astype(np.float32) * 1.6 - 0.8)
    H = torch.tensor([[1, 0, 0.2], [0, 1, 0.1], [0, 0, 1]], dtype=torch.float32)
    ones = torch.ones((n, 1))
    res = sharded_ransac(slots, torch.cat([apply_homography(H, m2), ones], 1),
                         torch.cat([m2, ones], 1), torch.ones(n, dtype=torch.bool), 0.05,
                         n_iter=512, generator=torch.Generator().manual_seed(1))
    out["ransac"] = (bool(res.found), int(res.num_inliers))

    resnet = init_resnet50_layer3(torch.Generator().manual_seed(2), "cpu")
    align = alignment_params_from_tree(trees, "cpu")
    arts = {}
    pooled_multihomo_predict(((i, _blocky(rng, 48, 48), _blocky(rng, 48, 48), None)
                              for i in range(2 * world)),
                             resnet, align, slots, dict(nb_scale=1, n_iter=256, min_size=48),
                             save_fn=lambda idx, art: arts.__setitem__(idx, art),
                             max_coarse=1, batch_pairs=2)
    out["pooled"] = {i: bool(np.isfinite(a["coarse_h"]).all()) for i, a in arts.items()}
    pyramids = (torch.from_numpy(rng.rand(world, 1, 32, 32, 3).astype(np.float32)),)
    targets = torch.from_numpy(rng.rand(world, 1, 32, 32, 3).astype(np.float32))
    served = sharded_align_pairs(slots, resnet, align, pyramids, targets,
                                 torch.Generator().manual_seed(3), n_iter=512,
                                 adaptive_chunk=256)
    out["served"] = {k: (tuple(v.shape), bool(torch.isfinite(v.float()).all()))
                     for k, v in served.items()}
    return out
