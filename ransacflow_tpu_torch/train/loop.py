"""The training loop on one device (port of `ransacflow_tpu/train/loop.py`):
epochs over a `PairFolder`, per-epoch loss averages in
<out_dir>/metrics.jsonl, periodic checkpoints (the reference's NoVal mode),
and the three-stage curriculum presets of train/stage{1,2,3}.sh."""

import os

import numpy as np
import torch

from ransacflow_tpu_torch.device import as_device
from ransacflow_tpu_torch.ops.grid import normalized_grid
from ransacflow_tpu_torch.train.checkpoint import save_checkpoint
from ransacflow_tpu_torch.train.data import PairFolder, prefetch
from ransacflow_tpu_torch.train.losses import margin_mask
from ransacflow_tpu_torch.train.trainer import (
    local_index_roll,
    make_optimizer,
    split_trainable,
    train_step,
)
from ransacflow_tpu_torch.utils.monitor import MetricsLogger

# stage presets (reference train/stage{1,2,3}.sh): mode, mu_cycle,
# lambda_match, grad, epochs
STAGES = {
    1: dict(mode="flow", mu_cycle=0.0, lambda_match=0.0, grad_weight=0.0, epochs=200),
    2: dict(mode="flow", mu_cycle=1.0, lambda_match=0.0, grad_weight=0.0, epochs=50),
    3: dict(mode="flow+match", mu_cycle=1.0, lambda_match=0.01, grad_weight=0.0,
            epochs=50),
}


def not_ported(name, item):
    """Raise for a reference feature the port does not have yet."""
    raise NotImplementedError(f"{name} is not ported yet (ROADMAP.md queue 1, {item})")


def fit(nets, train_dir, out_dir, device, mode="flow", mu_cycle=0.0,
        lambda_match=0.01, grad_weight=0.0, epochs=150, batch_size=16, img_size=224,
        margin=88, lr=2e-4, kernel_size=7, val_csv=None, epoch_save_model=10,
        n_devices=1, seed=0, log_every=50, max_steps_per_epoch=None,
        compute_dtype=None, remat=False, use_native=False):
    """Train the alignment networks `nets` (on `device`) in place on the
    image groups of `train_dir`; checkpoints go to `out_dir` as
    `checkpoint_epoch{e}.pt` every `epoch_save_model` epochs. Returns the
    optimizer."""
    if val_csv is not None:
        not_ported("MegaDepth validation (val_csv)", "item 11")
    if n_devices != 1:
        not_ported("data-parallel training (n_devices > 1)", "item 12")
    if compute_dtype is not None or remat:
        not_ported("bf16 compute and remat", "item 14")
    device = as_device(device)
    os.makedirs(out_dir, exist_ok=True)
    logger = MetricsLogger(out_dir)
    opt = make_optimizer(split_trainable(nets, mode)[0], lr)
    loss_kwargs = dict(mode=mode, mu_cycle=mu_cycle, lambda_match=lambda_match,
                       grad_weight=grad_weight, kernel_size=kernel_size)
    roll = local_index_roll(batch_size, device)
    grid = normalized_grid(img_size, img_size, device)[None]
    mask = margin_mask(2 * batch_size, img_size, margin, device)
    folder = PairFolder(train_dir, img_size=img_size, seed=seed, use_native=use_native)

    for epoch in range(epochs):
        sums, n_steps = {}, 0
        for batch in prefetch(folder.epoch_batches(batch_size)):
            imgs = torch.from_numpy(np.concatenate([batch["I1"], batch["I2"]]))
            metrics = train_step(nets, opt, imgs.to(device), roll, grid, mask,
                                 **loss_kwargs)
            n_steps += 1
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            if n_steps % log_every == 0:
                logger.log(epoch * 10000 + n_steps,
                           **{k: v / n_steps for k, v in sums.items()})
            if max_steps_per_epoch and n_steps >= max_steps_per_epoch:
                break
        logger.log(epoch, val_prec8=0.0,
                   **{k: v / max(n_steps, 1) for k, v in sums.items()})
        if (epoch + 1) % epoch_save_model == 0:
            save_checkpoint(os.path.join(out_dir, f"checkpoint_epoch{epoch}.pt"),
                            nets, opt, step=epoch)
    return opt
