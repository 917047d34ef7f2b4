"""The training step on one device (port of `ransacflow_tpu/train/trainer.py`,
single-device part): Adam over the mode's trained networks."""

import torch

from ransacflow_tpu_torch.train.losses import TRAIN_MODULES, compute_losses


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
    """roll(arange(2B), B): pairs image i with its counterpart."""
    return torch.roll(torch.arange(2 * batch_size, device=device), batch_size)


def train_step(nets, opt, images, index_roll, grid, mask_margin, mode="flow",
               mu_cycle=0.0, lambda_match=0.01, grad_weight=0.0, kernel_size=7):
    """One Adam step of `opt` (built over `split_trainable(nets, mode)[0]`)
    on the batch; the trained networks' BatchNorm statistics move too.

    Returns the metrics dict {'loss', 'loss_lr', 'loss_cycle', 'loss_match',
    'loss_grad'} of 0-d tensors on the batch's device (nothing is read back).
    """
    opt.zero_grad(set_to_none=True)
    loss, terms = compute_losses(nets, images, index_roll, grid, mask_margin,
                                 mode=mode, mu_cycle=mu_cycle,
                                 lambda_match=lambda_match, grad_weight=grad_weight,
                                 kernel_size=kernel_size)
    loss.backward()
    opt.step()
    return {"loss": loss.detach(), **{k: v.detach() for k, v in terms.items()}}
