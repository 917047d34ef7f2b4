"""The comparison that decides `correct` for the training cells.

The reference (`portbench/reference/train.py`) follows the first three
steps from the same weights on the same batches, and the program's readings
from its set-up (the losses, Adam's first moments after the first step, the
weights after the third) are held to it:

- `loss_gap`: the largest relative gap of a step's loss.
- `grad_norm_gap`: over the leaves, the largest gap between the norm of the
  program's first gradient (Adam's first moment over 1 - beta1) and the
  reference's, over the larger of the reference leaf's norm and the median
  leaf's.
- `change_norm_gap`: the same of the weights' change over the three steps.

Leaves whose reference gradient is under a thousandth of the median leaf's
are left out of both gap numbers: Adam moves such a leaf by round-off alone.
"""

import math

import numpy as np

from portbench.reference import train as ref

ZERO_GRAD_SHARE = 1e-3


def norm_gap(got, want, keep):
    """max over `keep` of | |got| - |want| | / max(|want|, median |want|)."""
    norms = {k: float(v.double().norm()) for k, v in want.items()}
    med = float(np.median([norms[k] for k in keep]))
    worst = 0.0
    for k in keep:
        g = float(got[k].double().norm())
        if not math.isfinite(g):
            return math.inf
        worst = max(worst, abs(g - norms[k]) / max(norms[k], med))
    return worst


def readings(checked, losses, first_grads, changes):
    gnorm = {k: float(v.double().norm()) for k, v in first_grads.items()}
    med = float(np.median(list(gnorm.values())))
    keep = [k for k, v in gnorm.items() if v >= ZERO_GRAD_SHARE * med]
    loss_gap = max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf
                   for a, b in zip(checked["losses"], losses))
    return {"loss_gap": loss_gap,
            "grad_norm_gap": norm_gap(checked["first_grads"], first_grads, keep),
            "change_norm_gap": norm_gap(checked["changes"], changes, keep)}


def judge(cfg, params, batches, checked):
    """params: the weights both sides started from; batches: the checked
    steps' batches; checked: the program's readings."""
    losses, first_grads, changes = ref.run_steps(params, batches, cfg["settings"])
    nums = readings(checked, losses, first_grads, changes)
    return [{"name": k, "value": float(nums[k]), "limit": float(cfg["limits"][k])}
            for k in cfg["limits"]]
