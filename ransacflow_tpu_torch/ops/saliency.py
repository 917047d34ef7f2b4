"""Feature self-similarity saliency (port of `ransacflow_tpu/ops/saliency.py`;
the reference's utils/outil.py:167-176, which its main path does not call).

The mean cosine similarity of each feature cell with its four neighbours,
reflect-padded at the border.
"""

import torch
import torch.nn.functional as F


def saliency_coef(feat):
    """(B, H, W, C) features (L2-normalized for a cosine) -> (B, H, W, 1): the
    mean of the dot products with the cells below, above, left and right,
    summed in that order."""
    _, h, w, _ = feat.shape
    padded = F.pad(feat.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1)
    neighbours = (padded[:, 2:2 + h, 1:1 + w],  # down
                  padded[:, 0:h, 1:1 + w],      # up
                  padded[:, 1:1 + h, 0:w],      # left
                  padded[:, 1:1 + h, 2:2 + w])  # right
    sims = [(feat * n).sum(dim=-1, keepdim=True) for n in neighbours]
    return torch.stack(sims).mean(dim=0)
