"""Coarse alignment: multi-scale features -> mutual matching -> RANSAC (port
of `ransacflow_tpu/pipeline/coarse.py`, homography or affine).

PIL resizing on the host; features, matching and the whole RANSAC search on
the aligner's device. The winning minimal set is optionally re-solved on the
host in fp64 (`polish_fp64`), as the reference's numpy SVD does.

`_match_masked`, `_homogeneous_matches` and `_mask_to_cells` are the one
implementation of the matching policy: the host loop (`get_coarse`), the
rotation pre-test (`dispatch_inlier_count`) and the device-resident loop
(`pipeline/multihomo._fused_multi_homo`) all call them.
"""

import numpy as np
import torch

from ransacflow_tpu_torch.device import as_device
from ransacflow_tpu_torch.ops.grid import feature_cell_coords
from ransacflow_tpu_torch.ops.homography import dlt_homography_np
from ransacflow_tpu_torch.ops.matching import mutual_matching
from ransacflow_tpu_torch.kernels.ransac import n_points_of
from ransacflow_tpu_torch.ops.ransac import (
    ransac_homography,
    ransac_homography_adaptive,
)
from ransacflow_tpu_torch.ops.sampler import interpolate_bilinear
from ransacflow_tpu_torch.pipeline.bank import anchor_bank, bank_coords, coarse_features
from ransacflow_tpu_torch.utils.image import (
    STRIDE_NET,
    resize_max_size,
    resize_min_size,
    scale_list,
    to_array,
)


def _coarse_feats(resnet, img):
    """img (1, H, W, 3) in [0, 1] -> L2-normalized (H/16 * W/16, 1024)."""
    return coarse_features(resnet, img).flatten(0, 2)


def _match_masked(bank, featt, mask_cell, cached_src, cached_valid, rematch,
                  relax_cells=0, grid_w=None):
    """Per-call masked matching: fresh (rematch: masked target cells score 0)
    or the cached matches filtered by the mask. Returns (src_idx, valid).
    relax_cells/grid_w: relaxed reciprocity for the fresh matching (the
    cached matches had it applied where they were built)."""
    if rematch:
        res = mutual_matching(bank.T, featt.T, validB=mask_cell,
                              relax_cells=relax_cells, grid_w=grid_w)
        return res.src_idx, res.valid
    return cached_src, cached_valid & mask_cell


def _homogeneous_matches(coords_a, coords_b, src_idx):
    """(m1, m2) homogeneous (nB, 3) match arrays keyed by target cell."""
    ones = torch.ones((coords_b.shape[0], 1), dtype=torch.float32,
                      device=coords_b.device)
    m1 = torch.cat([coords_a[src_idx.long()], ones], dim=1)
    m2 = torch.cat([coords_b, ones], dim=1)
    return m1, m2


def _mask_to_cells(mask_full, fh, fw):
    """Full-res exclusion mask (Ht, Wt) -> per-feature-cell KEEP mask (nB,):
    (1 - mask) bilinearly resized to the feature grid, > 0.5 (reference:
    evaluation/evalHpatch/coarseAlignFeatMatch.py:158-162)."""
    keep = 1.0 - mask_full
    cell = interpolate_bilinear(keep[None, :, :, None], fh, fw)[0, :, :, 0]
    return (cell > 0.5).reshape(-1)


class CoarseAligner:
    """Multi-scale coarse alignment (homography or affine).

    Args:
      resnet: `ResNet50Layer3` on `device`, in eval mode.
      device: the device of every tensor of this aligner (no default).
      nb_scale: source pyramid size.
      n_iter: RANSAC hypothesis count (the cap with adaptive_chunk).
      tolerance: inlier threshold in normalized units.
      transform: 'homography' (4-point sets) or 'affine' (3-point
        least-squares fits; no fp64 polish).
      min_size: resized image min (or max, see resize_mode) dimension.
      scale_r: pyramid scale range (scale_r .. 1/scale_r).
      resize_mode: 'min' (eval harnesses) | 'max' (quick-start demo).
      rematch_per_call: re-match the masked target features on every
        `get_coarse` (quick-start/YFCC) instead of filtering the matches
        cached by `set_target` (eval harnesses).
      polish_fp64: re-solve the winning minimal set on the host in fp64.
      seed: seed of the RANSAC draws (see `reseed`).
      adaptive_chunk: > 0 switches RANSAC to confidence-based early
        termination (`ops.ransac.ransac_homography_adaptive`) with this
        block size, here and in the device-resident loop; n_iter becomes
        the cap. Ignored when injected_samples are given.
      anchor_stride: > 0 runs the trunk at every k-th pyramid scale only
        (index 0 first) and resamples the other scales' bank rows from the
        nearest anchor's map (`pipeline.bank.anchor_bank`, kernel 12).
      relax_cells: > 0 accepts a match whose back-match lands within this
        Chebyshev radius in target cells (`ops.matching.mutual_matching`).
      stem_s2d: a TPU rewrite of the stem that the port leaves out (ROADMAP,
        "Not ported"); True raises.
    """

    def __init__(self, resnet, device, nb_scale=7, n_iter=10000, tolerance=0.05,
                 transform="homography", min_size=400, scale_r=2.0,
                 resize_mode="min", rematch_per_call=False, polish_fp64=True,
                 seed=0, adaptive_chunk=0, anchor_stride=0, relax_cells=0,
                 stem_s2d=False):
        if stem_s2d:
            raise ValueError("stem_s2d is a TPU rewrite of the stem that the port "
                             "leaves out (ROADMAP, 'Not ported')")
        if resize_mode not in ("min", "max"):
            raise ValueError(f"resize_mode={resize_mode!r}: 'min' or 'max'")
        self.resnet = resnet
        self.device = as_device(device)
        self.n_iter = int(n_iter)
        self.tolerance = float(tolerance)
        self.transform = transform
        self.n_points = n_points_of(transform)
        # the fits' keyword arguments: none for the default homography
        self._fit_kw = ({} if transform == "homography"
                        else {"n_points": self.n_points, "transform": transform})
        self.min_size = int(min_size)
        self.scales = scale_list(nb_scale, scale_r)
        self.rematch = bool(rematch_per_call)
        self.polish_fp64 = bool(polish_fp64)
        self.seed = int(seed)
        self.adaptive_chunk = int(adaptive_chunk)
        self.anchor_stride = int(anchor_stride)
        self.relax_cells = int(relax_cells)
        self._resize = resize_min_size if resize_mode == "min" else resize_max_size
        self.generator = torch.Generator(self.device).manual_seed(self.seed)

    def put(self, arr):
        """Host array -> tensor on this aligner's device."""
        return torch.as_tensor(np.asarray(arr)).to(self.device)

    def reseed(self, index, seed=None):
        """Reset the RANSAC draws to a stream that depends on (seed, index)
        alone, so that each pair's hypotheses do not depend on the order in
        which pairs are visited. The numbers differ from the JAX package's
        `fold_in(PRNGKey(seed), index)`: the generators differ."""
        seed = self.seed if seed is None else int(seed)
        mixed = np.random.SeedSequence([seed, int(index)]).generate_state(1, np.uint64)[0]
        self.generator = torch.Generator(self.device).manual_seed(int(mixed))

    # -- pair setup ---------------------------------------------------------

    @torch.inference_mode()
    def set_source(self, img):
        """Extract the multi-scale source feature bank. `img` is PIL."""
        imgs = [self._resize(img, int(self.min_size * s)) for s in self.scales]
        # the mid-scale image is the one the fine stage warps
        self.src_img = imgs[len(self.scales) // 2]
        self.src_array = to_array(self.src_img)
        arrs = [to_array(im) for im in imgs]
        if self.anchor_stride:
            self._bank = anchor_bank(self.resnet, [self.put(a)[None] for a in arrs],
                                     self.anchor_stride, STRIDE_NET)[0]
        else:
            self._bank = torch.cat([_coarse_feats(self.resnet, self.put(a)[None])
                                    for a in arrs])  # (nA, 1024)
        self._coordsA = bank_coords([a.shape[:2] for a in arrs], self.device, STRIDE_NET)

    @torch.inference_mode()
    def set_target(self, img):
        """Extract target features and (unless rematch mode) cache matches."""
        self.tgt_img = self._resize(img, self.min_size)
        self.tgt_array = to_array(self.tgt_img)
        self._featt = _coarse_feats(self.resnet, self.put(self.tgt_array)[None])
        self.feat_h = self.tgt_array.shape[0] // STRIDE_NET
        self.feat_w = self.tgt_array.shape[1] // STRIDE_NET
        y, x = feature_cell_coords(self.feat_h, self.feat_w, self.device)
        self._coordsB = torch.stack([x, y], dim=1)  # (nB, 2)
        n_b = self._featt.shape[0]
        if self.rematch:
            self._cached_src = torch.zeros(n_b, dtype=torch.int32, device=self.device)
            self._cached_valid = torch.zeros(n_b, dtype=torch.bool, device=self.device)
        else:
            res = mutual_matching(self._bank.T, self._featt.T,
                                  relax_cells=self.relax_cells, grid_w=self.feat_w)
            self._cached_src, self._cached_valid = res.src_idx, res.valid

    def set_pair(self, img_src, img_tgt):
        self.set_source(img_src)
        self.set_target(img_tgt)

    # -- per-iteration coarse fit ------------------------------------------

    def _masked_matches(self, exclusion_mask):
        ht, wt = self.tgt_array.shape[:2]
        if exclusion_mask is None:
            exclusion_mask = np.zeros((ht, wt), np.float32)
        mask_cell = _mask_to_cells(self.put(np.asarray(exclusion_mask, np.float32)),
                                   self.feat_h, self.feat_w)
        src_idx, valid = _match_masked(self._bank, self._featt, mask_cell,
                                       self._cached_src, self._cached_valid,
                                       self.rematch, self.relax_cells, self.feat_w)
        m1, m2 = _homogeneous_matches(self._coordsA, self._coordsB, src_idx)
        return m1, m2, valid

    def _ransac(self, m1, m2, valid, generator):
        if self.adaptive_chunk:
            res, _ = ransac_homography_adaptive(
                m1, m2, valid, self.tolerance, n_iter=self.n_iter,
                chunk=self.adaptive_chunk, generator=generator, **self._fit_kw)
            return res
        return ransac_homography(m1, m2, valid, self.tolerance, n_iter=self.n_iter,
                                 generator=generator, **self._fit_kw)

    @torch.inference_mode()
    def get_coarse(self, exclusion_mask=None, injected_samples=None):
        """Fit the dominant transform on the not-yet-excluded target region.

        exclusion_mask: (Ht, Wt) float/bool array, 1 = exclude (already
          matched / sky); None = use everything.
        injected_samples: optional (n, n_points) int array of target-cell
          indices used as the minimal sets instead of drawing (fixed-count
          RANSAC over exactly these n sets).

        Returns (H21, inlier_mask_image): H21 a float32 (3, 3) numpy array
        mapping target normalized coords to source normalized coords, or
        (None, None) when no model is found; inlier_mask_image marks the
        inlier target cells on the (feat_h, feat_w) grid.
        """
        m1, m2, valid = self._masked_matches(exclusion_mask)
        if int(valid.sum()) < self.n_points:
            return None, None
        if injected_samples is None:
            res = self._ransac(m1, m2, valid, self.generator)
        else:
            samples = torch.as_tensor(np.asarray(injected_samples, np.int32))
            res = ransac_homography(m1, m2, valid, self.tolerance,
                                    n_iter=samples.shape[0], injected_samples=samples,
                                    **self._fit_kw)
        if not bool(res.found):
            return None, None
        H = res.H21.cpu().numpy().astype(np.float64)
        if self.polish_fp64 and self.transform == "homography":
            sample = res.best_sample.cpu().numpy()
            H = dlt_homography_np(m1.cpu().numpy()[sample, :2],
                                  m2.cpu().numpy()[sample, :2])
        inlier = res.inlier_mask.cpu().numpy().reshape(self.feat_h, self.feat_w)
        return H.astype(np.float32), inlier.astype(np.float32)

    @torch.inference_mode()
    def dispatch_inlier_count(self, exclusion_mask=None, generator=None):
        """Run a coarse RANSAC and return its inlier count without reading it
        back: a () int32 device tensor, 0 when no model is found. It sums
        the winner's reprojection-error mask, as the sequential rotation
        test does. generator: None draws from the aligner's stream."""
        m1, m2, valid = self._masked_matches(exclusion_mask)
        res = self._ransac(m1, m2, valid,
                           self.generator if generator is None else generator)
        return torch.where(res.found, res.inlier_mask.sum(dtype=torch.int32),
                           torch.zeros((), dtype=torch.int32, device=self.device))

    @property
    def num_cached_matches(self):
        return int(self._cached_valid.sum())
