"""The training loop (port of `ransacflow_tpu/train/loop.py`): epochs over a
`PairFolder`, per-epoch loss averages and the validation's prec@8 in
<out_dir>/metrics.jsonl, the best model by MegaDepth validation (the
reference's valMegaDepth mode) or periodic checkpoints (its NoVal mode), and
the three-stage curriculum presets of train/stage{1,2,3}.sh. On one device,
or data-parallel with one process a device (`parallel.group`)."""

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from ransacflow_tpu_torch.device import as_device
from ransacflow_tpu_torch.eval.table import read_rows
from ransacflow_tpu_torch.ops.grid import normalized_grid
from ransacflow_tpu_torch.parallel.group import broadcast_module
from ransacflow_tpu_torch.train.checkpoint import save_checkpoint
from ransacflow_tpu_torch.train.data import PairFolder, prefetch
from ransacflow_tpu_torch.train.losses import margin_mask
from ransacflow_tpu_torch.train.trainer import (
    local_index_roll,
    make_optimizer,
    split_trainable,
    train_step,
)
from ransacflow_tpu_torch.train.validation import validate
from ransacflow_tpu_torch.utils.monitor import MetricsLogger

# stage presets (reference train/stage{1,2,3}.sh): mode, mu_cycle,
# lambda_match, grad, epochs
STAGES = {
    1: dict(mode="flow", mu_cycle=0.0, lambda_match=0.0, grad_weight=0.0, epochs=200),
    2: dict(mode="flow", mu_cycle=1.0, lambda_match=0.0, grad_weight=0.0, epochs=50),
    3: dict(mode="flow+match", mu_cycle=1.0, lambda_match=0.01, grad_weight=0.0,
            epochs=50),
}


def process_shard_layout(batch_size, n_devices, process_index, process_count):
    """Validate + derive the per-process share of a multi-process DP layout
    (a copy of `ransacflow_tpu/train/loop.py:30-63`).

    Returns (host_batch, local_devices): how many pairs this process loads
    per step and how many devices its data covers. PairFolder(shard_index=
    process_index, num_shards=process_count) is the reference's
    DistributedSampler; this function sizes the per-rank batch.
    """
    if process_count < 1 or not 0 <= process_index < process_count:
        raise ValueError(
            f"bad process grid: index {process_index} of {process_count}")
    if n_devices % process_count:
        raise ValueError(
            f"n_devices ({n_devices}) must be divisible by the process "
            f"count ({process_count}) — every host contributes the same "
            f"number of mesh devices")
    if batch_size % n_devices:
        raise ValueError(
            f"batch_size ({batch_size}) must be divisible by n_devices "
            f"({n_devices})")
    local_devices = n_devices // process_count
    host_batch = batch_size // process_count
    return host_batch, local_devices


def _dp_group(n_devices):
    """The default process group for data parallelism over `n_devices`
    ranks (None for one device); raises unless one is initialized with one
    rank a device."""
    if n_devices == 1:
        return None
    if not dist.is_initialized():
        raise ValueError(f"n_devices={n_devices} trains one process a device: initialize "
                         "a process group of that many ranks first (parallel.spawn, "
                         "parallel.init_from_env, or cli.train --nDevices / --distributed)")
    world = dist.get_world_size()
    if world != n_devices:
        raise ValueError(f"n_devices={n_devices}, but the process group has {world} ranks "
                         "(one process a device)")
    return dist.group.WORLD


def fit(nets, train_dir, out_dir, device, mode="flow", mu_cycle=0.0,
        lambda_match=0.01, grad_weight=0.0, epochs=150, batch_size=16, img_size=224,
        margin=88, lr=2e-4, kernel_size=7, val_csv=None, val_dir=None,
        val_coarse_pkl=None, val_min_size=480, epoch_save_model=10,
        n_devices=1, seed=0, log_every=50, max_steps_per_epoch=None,
        compute_dtype=None, remat=False, use_native=False):
    """Train the alignment networks `nets` (on `device`) in place on the
    image groups of `train_dir`.

    With `val_csv` (and `val_dir`, `val_coarse_pkl`, `val_min_size`: the
    MegaDepth validation set, see `train.validation.validate`) every epoch
    is validated and its prec@8 logged; the model is saved to
    `<out_dir>/BestModel` whenever prec@8 improves, and renamed
    `BestModel@8_{prec:.3f}` at the end. Without it, checkpoints go to
    `out_dir` as `checkpoint_epoch{e}.pt` every `epoch_save_model` epochs and
    prec@8 is logged as 0. use_native: resize the training crops with the
    native Lanczos resampler (`ransacflow_tpu_torch.native`). compute_dtype
    ('bfloat16'): the mixed-precision policy (bf16 convolutions, fp32
    masters, BatchNorm and Adam state); remat: recompute the feature trunk
    in the backward (`train.losses.compute_losses`). Validation runs the
    fp32 networks, as the reference's does.

    n_devices > 1: data parallelism, one process a device, in an initialized
    process group of n_devices ranks (`parallel.spawn`, or a torchrun
    launch and `parallel.init_from_env`); every rank calls `fit` with its
    own `device`. `batch_size` is the GLOBAL batch: each rank loads
    batch_size / n_devices pairs a step from its rank-strided shard of the
    groups (`PairFolder(shard_index, num_shards)`) as concat(I1_r, I2_r)
    with the shard-local roll, and the step is the one large batch's
    (`train.trainer.train_grads`). The replicas start from rank 0's
    networks. Rank 0 alone validates, logs and saves; the others wait for
    it at the epoch's end.

    Returns (the optimizer, the best prec@8, 0.0 without validation).
    """
    device = as_device(device)
    group = _dp_group(n_devices)
    process_index = 0 if group is None else dist.get_rank(group)
    process_count = 1 if group is None else dist.get_world_size(group)
    host_batch, local_devices = process_shard_layout(batch_size, n_devices, process_index,
                                                     process_count)
    if local_devices != 1:
        raise ValueError(f"{local_devices} devices a process: the port runs one process "
                         "a device")
    chief = process_index == 0
    broadcast_module(nets, group)
    if chief:
        os.makedirs(out_dir, exist_ok=True)
    logger = MetricsLogger(out_dir) if chief else None
    opt = make_optimizer(split_trainable(nets, mode)[0], lr)
    loss_kwargs = dict(mode=mode, mu_cycle=mu_cycle, lambda_match=lambda_match,
                       grad_weight=grad_weight, kernel_size=kernel_size,
                       compute_dtype=compute_dtype, remat=remat, group=group)
    roll = local_index_roll(host_batch, device)
    grid = normalized_grid(img_size, img_size, device)[None]
    mask = margin_mask(2 * host_batch, img_size, margin, device)
    folder = PairFolder(train_dir, img_size=img_size, seed=seed, shard_index=process_index,
                        num_shards=process_count, use_native=use_native)
    rows = coarse_transforms = None
    if val_csv is not None and chief:
        rows = read_rows(val_csv)
        with open(val_coarse_pkl, "rb") as f:
            coarse_transforms = pickle.load(f)
    best_prec = 0.0
    best_path = os.path.join(out_dir, "BestModel")

    for epoch in range(epochs):
        sums, n_steps = {}, 0
        for batch in prefetch(folder.epoch_batches(host_batch)):
            # one device a process: the interleave of the reference's DP
            # layout (shard d holds concat(I1_d, I2_d)) is this concat
            imgs = torch.from_numpy(np.concatenate([batch["I1"], batch["I2"]]))
            metrics = train_step(nets, opt, imgs.to(device), roll, grid, mask,
                                 **loss_kwargs)
            n_steps += 1
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            if logger and n_steps % log_every == 0:
                logger.log(epoch * 10000 + n_steps,
                           **{k: v / n_steps for k, v in sums.items()})
            if max_steps_per_epoch and n_steps >= max_steps_per_epoch:
                break
        if chief:
            prec8 = 0.0
            if rows is not None:
                prec8 = float(validate(rows, val_dir, coarse_transforms, nets, device,
                                       kernel_size=kernel_size, min_size=val_min_size)[4])
            logger.log(epoch, val_prec8=prec8,
                       **{k: v / max(n_steps, 1) for k, v in sums.items()})
            if rows is not None and prec8 > best_prec:
                best_prec = prec8
                save_checkpoint(best_path, nets, opt, step=epoch)
                print(f"epoch {epoch}: val prec@8 improved to {prec8:.4f}")
            elif rows is None and (epoch + 1) % epoch_save_model == 0:
                save_checkpoint(os.path.join(out_dir, f"checkpoint_epoch{epoch}.pt"),
                                nets, opt, step=epoch)
        if group is not None:
            dist.barrier(group)  # the others wait for rank 0's validation and saves
    if chief and rows is not None and os.path.exists(best_path):
        os.rename(best_path, os.path.join(out_dir, f"BestModel@8_{best_prec:.3f}"))
    return opt, best_prec
