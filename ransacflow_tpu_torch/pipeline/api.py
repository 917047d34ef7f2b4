"""The public two-image aligner (port of `ransacflow_tpu/pipeline/api.py`,
the reference's quick-start surface).

`RansacFlowAligner.align_images(img1, img2)` fits the coarse homography by
multi-scale matching and RANSAC, runs one fine flow pass and returns the
homography, the composed dense flow, the matchability and the warped
source, as numpy arrays on the host.
"""

import torch

from ransacflow_tpu_torch.device import as_device
from ransacflow_tpu_torch.kernels.warp_sample import warp_sample
from ransacflow_tpu_torch.models.convert import (
    load_alignment_checkpoint,
    load_resnet50_trunk,
)
from ransacflow_tpu_torch.pipeline.coarse import CoarseAligner
from ransacflow_tpu_torch.pipeline.fine import fine_features, pred_flow_mask_homography

QUICK_START = dict(nb_scale=7, n_iter=10000, tolerance=0.05, transform="homography",
                   min_size=400, scale_r=1.2, resize_mode="max", rematch_per_call=True)


class RansacFlowAligner:
    """End-to-end two-stage aligner.

    Args:
      align: the alignment networks (`models.convert.init_alignment_params`
        or `load_alignment_checkpoint`) on `device`.
      resnet: the coarse ResNet-50 trunk on `device`.
      device: the device every tensor of the aligner lives on.
      kernel_size: correlation neighbourhood (default 7).
      coarse_kwargs: forwarded to `CoarseAligner` over the quick-start
        defaults (`QUICK_START`: 7 scales, 10k hypotheses, tolerance 0.05,
        min_size 400, scale_r 1.2, max-side resize, re-matching per call);
        `anchor_stride`, `relax_cells` and `adaptive_chunk` included.
    """

    def __init__(self, align, resnet, device, kernel_size=7, **coarse_kwargs):
        self.params = align
        self.kernel_size = kernel_size
        self.device = as_device(device)
        self.coarse = CoarseAligner(resnet, self.device, **{**QUICK_START, **coarse_kwargs})

    @classmethod
    def from_checkpoints(cls, align_pth, resnet_source, device, moco=False,
                         kernel_size=7, **kw):
        """Build from the reference's released .pth files."""
        return cls(load_alignment_checkpoint(align_pth, device, kernel_size),
                   load_resnet50_trunk(resnet_source, device, moco=moco), device,
                   kernel_size=kernel_size, **kw)

    @torch.inference_mode()
    def align_images(self, img1, img2, cycle_match=False, exclusion_mask=None):
        """Align source `img1` onto target `img2` (both PIL images).

        exclusion_mask: optional (Ht, Wt) array over the resized target, 1 =
          exclude from coarse matching (a sky mask, say).

        Returns dict: 'H21' (3, 3) coarse homography (target -> source,
        normalized), or None alone when no model was found; 'flow'
        (Ht, Wt, 2) composed fine sampling grid; 'match' (Ht, Wt)
        matchability; 'warped_coarse', 'warped_fine' (Ht, Wt, 3) warped
        source; 'target' (Ht, Wt, 3) the resized target.
        """
        c = self.coarse
        c.set_pair(img1, img2)
        H, _ = c.get_coarse(exclusion_mask)
        if H is None:
            return {"H21": None}
        ht, wt = c.tgt_array.shape[:2]
        src = c.put(c.src_array)[None]
        featt = fine_features(self.params, c.put(c.tgt_array)[None])
        out = pred_flow_mask_homography(self.params, src, featt, c.put(H)[None], (ht, wt),
                                        cycle_match=cycle_match,
                                        kernel_size=self.kernel_size)
        return {
            "H21": H,
            "flow": out["flow"][0].cpu().numpy(),
            "match": out["match"].cpu().numpy(),
            "warped_coarse": out["warped"][0].cpu().numpy(),
            "warped_fine": warp_sample(src, out["flow"].contiguous())[0].cpu().numpy(),
            "target": c.tgt_array,
        }
