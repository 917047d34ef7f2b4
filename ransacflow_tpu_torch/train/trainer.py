"""The training step (port of `ransacflow_tpu/train/trainer.py`): Adam over
the mode's trained networks, on one device or data-parallel over the ranks
of a process group (`make_data_parallel_step`'s shard_map: each rank holds
its share of the global batch and a replica of the networks)."""

import torch

from ransacflow_tpu_torch.parallel.group import reduce_grads
from ransacflow_tpu_torch.train.losses import TRAIN_MODULES, compute_losses
from ransacflow_tpu_torch.utils.monitor import span


def make_optimizer(params, lr=2e-4):
    """The reference's Adam: lr 2e-4, betas (0.5, 0.999), eps 1e-8, the
    algebra of `optax.adam`."""
    return torch.optim.Adam(params, lr=lr, betas=(0.5, 0.999), eps=1e-8)


def split_trainable(nets, mode):
    """(trainable, frozen) parameter lists of the networks for a loss mode."""
    trained = TRAIN_MODULES[mode]
    trainable = [p for name in trained for p in nets[name].parameters()]
    frozen = [p for name, net in nets.items() if name not in trained
              for p in net.parameters()]
    return trainable, frozen


def local_index_roll(batch_size, device):
    """roll(arange(2B), B): pairs image i with its counterpart. Under data
    parallelism each rank's batch is concat(I1_r, I2_r) and its roll is the
    local one."""
    return torch.roll(torch.arange(2 * batch_size, device=device), batch_size)


def train_grads(nets, opt, images, index_roll, grid, mask_margin, mode="flow",
                mu_cycle=0.0, lambda_match=0.01, grad_weight=0.0, kernel_size=7,
                compute_dtype=None, remat=False, group=None):
    """The step up to `opt.step()`: the losses, the backward and, under
    `group`, the gradients reduced over its ranks (`parallel.group`: the
    global loss's backward, then the average), so that every rank holds the
    gradient of the one large batch in its trainable parameters' `.grad`.
    The trained networks' BatchNorm statistics move (global moments under
    `group`). Returns the metrics dict of `train_step`."""
    with span("rf.train.forward"):
        opt.zero_grad(set_to_none=True)
        loss, terms = compute_losses(nets, images, index_roll, grid, mask_margin,
                                     mode=mode, mu_cycle=mu_cycle,
                                     lambda_match=lambda_match, grad_weight=grad_weight,
                                     kernel_size=kernel_size, compute_dtype=compute_dtype,
                                     remat=remat, group=group)
    with span("rf.train.backward"):
        loss.backward()
        reduce_grads(split_trainable(nets, mode)[0], group)
    return {"loss": loss.detach(), **{k: v.detach() for k, v in terms.items()}}


def train_step(nets, opt, images, index_roll, grid, mask_margin, mode="flow",
               mu_cycle=0.0, lambda_match=0.01, grad_weight=0.0, kernel_size=7,
               compute_dtype=None, remat=False, group=None):
    """One Adam step of `opt` (built over `split_trainable(nets, mode)[0]`)
    on the batch; the trained networks' BatchNorm statistics move too.
    compute_dtype, remat: `train.losses.compute_losses`'s; the master
    weights, their gradients and Adam's state stay fp32 under either.
    group: data parallelism over its ranks (`train_grads`); the replicas
    must start equal (`parallel.group.broadcast_module`) and stay so.

    Returns the metrics dict {'loss', 'loss_lr', 'loss_cycle', 'loss_match',
    'loss_grad'} of 0-d tensors on the batch's device (nothing is read back):
    the global batch's under `group`.
    """
    with span("rf.train.step"):
        metrics = train_grads(nets, opt, images, index_roll, grid, mask_margin, mode=mode,
                              mu_cycle=mu_cycle, lambda_match=lambda_match,
                              grad_weight=grad_weight, kernel_size=kernel_size,
                              compute_dtype=compute_dtype, remat=remat, group=group)
        with span("rf.train.optimizer"):
            opt.step()
        return metrics
