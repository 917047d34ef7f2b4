"""The comparison that decides `correct` for the alignment cells.

For each judged pair (drawn from the seed among the pairs the window
finished) the plain reference (`portbench/reference/align.py`) rebuilds the
source pyramid, the trunk features of every scale and of the target, and the
mutual matches, and then holds the program's outputs to it:

- `inlier_recount_gap` (exact, limit 0): the program's `num_inliers` against
  the reference's count of the program's own H21 over the reference's
  matches, less the matches that lie within 1e-5 of the tolerance (a
  last-bit change of H flips those) and the target cells whose match leads
  its runner-up by less than 1e-5 in score (a last-bit change of the
  features flips those: the blocky scenes hold exact ties).
- `ransac_best_gap` (exact, limit 0): how far the program's `num_inliers`
  (0 for a pair it reports as not found) falls below the best count of
  the reference's own RANSAC (its own draws, as many hypotheses), less the
  same near and tied matches of both fits: a fit that returns another
  hypothesis than the best, with that hypothesis's honest count, reads
  above 0. On these scenes every 4-point set of true matches gives the
  planted shift and the best count, so any sound fit of as many draws
  finds it.
- `flow_gap`: the largest absolute difference of `flow` and `flow_down8`
  (normalized coordinates) from the reference's fine stage run at the
  program's H21.
- `match_gap`: the same of `match_down8` and of `match` off the pixels
  whose composed flow lies within 1e-4 of the border, where the in-bounds
  step makes a last-bit difference a jump of the whole value.

RANSAC's draws are the program's own, so the reference follows the program
from its H21 on: it checks the fit by what it says (its inlier count) and
by whether it is the best (against the reference's own fit); the stages
before it (pyramid, trunk, matching) are the reference's own.
"""

import math

import numpy as np
import torch

from portbench.reference import align as ref

BORDER_EPS = 1e-4
TIE_EPS = 1e-5
CHECKS = ("inlier_recount_gap", "ransac_best_gap", "flow_gap", "match_gap")


def _max_abs(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return math.inf
    if a.size == 0:
        return 0.0
    d = np.abs(a - b)
    return float(d.max()) if np.isfinite(d).all() else math.inf


def judge_pair(cfg, shapes, trunk, fine, src, tgt, out, gen):
    """The three numbers of one pair, and its count of valid matches."""
    c = cfg["settings"]
    tol = c["tolerance"]
    with torch.no_grad():
        pyr = ref.pyramid(src, shapes)
        m1, m2, valid, margin = ref.coarse_matches(trunk, pyr, tgt)
        ties = int((margin < TIE_EPS).sum())
        found, count = bool(out["found"]), int(out["num_inliers"])
        H = torch.as_tensor(np.asarray(out["H21"], np.float32), device=src.device)
        if not torch.isfinite(H).all():
            return {k: math.inf for k in CHECKS}, int(valid.sum())
        H_best, best, _ = ref.ransac(m1, m2, valid, tol, c["n_hypotheses"], gen)
        near_best = int(ref.count_inliers(H_best[None], m1, m2, valid, tol)[1][0])
        gap, near = 0, 0
        if found:
            hit, near = (int(x[0]) for x in ref.count_inliers(H[None], m1, m2, valid, tol))
            gap = max(0, abs(count - hit) - near - ties)
        else:
            count = 0
        best_gap = max(0, best - count - near - near_best - ties)
        want = ref.gated(ref.fine_stage(fine, pyr[len(pyr) // 2], tgt, H, c["kernel_size"]),
                         found, *tgt.shape[1:3])
        want = ref.to_numpy(want)
    flow = np.asarray(out["flow"])[0]
    flow_gap = max(_max_abs(flow, want["flow"]),
                   _max_abs(np.asarray(out["flow_down8"])[0], want["flow_down8"]))
    match, wm = np.asarray(out["match"]), want["match"]
    off_border = (np.abs(np.abs(want["flow"]) - 1.0) > BORDER_EPS).all(axis=-1)
    if match.shape == wm.shape:
        match_gap = _max_abs(match[off_border], wm[off_border])
    else:
        match_gap = math.inf
    match_gap = max(match_gap, _max_abs(np.asarray(out["match_down8"])[0],
                                        want["match_down8"]))
    return {"inlier_recount_gap": gap, "ransac_best_gap": best_gap, "flow_gap": flow_gap,
            "match_gap": match_gap}, int(valid.sum())


def judge(cfg, shapes, trunk, fine, items, session, gen):
    """items: [(source (1, Hs, Ws, 3), target (1, Ht, Wt, 3), the program's
    outputs of that pair)]. Returns the checks, each number the worst over
    the pairs, beside its limit; no judged pair reads as infinitely wrong."""
    worst = {k: (math.inf if not items else 0.0) for k in cfg["limits"]}
    valid = []
    for src, tgt, out in items:
        nums, n_valid = judge_pair(cfg, shapes, trunk, fine, src, tgt, out, gen)
        valid.append(n_valid)
        for k, v in nums.items():
            worst[k] = max(worst[k], v)
    session.valid_matches_mean = float(np.mean(valid)) if valid else None
    return [{"name": k, "value": float(worst[k]), "limit": float(cfg["limits"][k])}
            for k in cfg["limits"]]
