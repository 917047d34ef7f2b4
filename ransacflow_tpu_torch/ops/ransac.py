"""RANSAC over padded match arrays, fixed-count and adaptive (port of
`ransacflow_tpu/ops/ransac.py:54-304`): 4-point homographies with the |det|
gate, or 3-point affine maps (least squares, no gate).

A fit draws one int64 seed from the caller's `torch.Generator` (one launch,
nothing read back; the generator advances by the same amount whatever the
fit does) and hands it to its kernel: the fixed-count fit is kernel 3
(`kernels/ransac.py`), the adaptive loop with its stop test kernel 4
(`kernels/ransac_adaptive.py`). Each draws its minimal sets with Philox
inside the kernel, solves, scores, picks the winner and writes its inlier
mask in one launch. CPU tensors take the kernels' plain versions, whose
draws are the kernels' bit for bit. Matches with a leading pair axis are k
pairs' fits in one launch, pair p under seed p.
"""

import torch

from ransacflow_tpu_torch.kernels.ransac import draw_sets_ref, n_points_of, ransac_fit
from ransacflow_tpu_torch.kernels.ransac_adaptive import ransac_adaptive


def draw_seed(generator, device):
    """(1,) int64 seed of a fit's draws, in [0, 2**62), from `generator`."""
    return torch.randint(0, 2 ** 62, (1,), generator=generator, device=device)


def draw_seeds(generator, k, device):
    """(k,) int64 seeds of k fits: pair p's from generator[p] when
    `generator` is a list of k generators, else from the one generator in
    pair order, one `draw_seed` a pair (the seeds k fits drawn one after
    another take)."""
    gens = generator if isinstance(generator, (list, tuple)) else [generator] * k
    return torch.cat([draw_seed(g, device) for g in gens])


def sample_minimal_sets(valid, n_iter, generator, n_points=4):
    """(n_iter, n_points) int32 match indices drawn uniformly from the valid
    matches, with replacement (sets with a repeated index are rejected by
    the scorer): the sets a fit of `n_iter` hypotheses draws from the same
    generator state (`kernels.ransac.draw_sets_ref`)."""
    return draw_sets_ref(valid, draw_seed(generator, valid.device), n_iter,
                         n_points=n_points)


def _check_transform(n_points, transform):
    if n_points_of(transform) != n_points:
        raise ValueError(f"transform={transform!r} takes {n_points_of(transform)}-point "
                         f"sets, got n_points={n_points}")


def _draws(match1, generator, injected_samples, n_rows, n_points):
    """The kernel's draws for the fit of match1 (N, 3), or for the k fits of
    match1 (k, N, 3): {'seed': one seed a fit, `draw_seeds`' for k}, or
    {'samples': `injected_samples` checked to be (n_rows, n_points) match
    indices in [0, N) a fit, (k, n_rows, n_points) for k}."""
    lead, dev = tuple(match1.shape[:-2]), match1.device
    if injected_samples is None:
        return {"seed": draw_seeds(generator, lead[0], dev) if lead else
                draw_seed(generator, dev)}
    shape = lead + (n_rows, n_points)
    samples = injected_samples.to(device=dev, dtype=torch.int32).contiguous()
    if tuple(samples.shape) != shape or bool(
            ((samples < 0) | (samples >= match1.shape[-2])).any()):
        raise ValueError(f"injected_samples must be {shape} match indices in [0, N)")
    return {"samples": samples}


def ransac_homography(match1, match2, valid, tolerance, n_iter=10000,
                      generator=None, injected_samples=None, n_points=4,
                      transform="homography"):
    """RANSAC over match1, match2 (N, 3) homogeneous points and valid (N,),
    or over k pairs' (k, N, 3) and (k, N) in one launch.

    tolerance: inlier threshold in normalized [-1, 1] units.
    generator: the `torch.Generator` the seed of the draws comes from (on
      the matches' device); for k pairs, k seeds drawn from it in pair order
      before the fit, as k fits one after another draw them, or a list of k
      generators, pair p's seed from the p-th.
    injected_samples: optional (n_iter, n_points) int32 match indices used
      instead of drawing ((k, n_iter, n_points) for k pairs), so that a test
      can feed the reference's draws.
    n_points / transform: 4 and 'homography' (the 4-point solve), or 3 and
      'affine' (the 3-point least-squares fit).

    Returns `kernels.ransac.RansacResult`, with a leading pair axis for k
    pairs; pair p's fit is that of its matches alone under its seed.
    """
    _check_transform(n_points, transform)
    res, _ = ransac_fit(match1, match2, valid, tolerance, n_iter, transform=transform,
                        **_draws(match1, generator, injected_samples, n_iter, n_points))
    return res


def ransac_homography_adaptive(match1, match2, valid, tolerance, n_iter=50000,
                               chunk=4096, confidence=0.999, generator=None,
                               injected_samples=None, n_points=4,
                               transform="homography"):
    """RANSAC with confidence-based early termination: hypotheses in blocks
    of `chunk`, stopping once (blocks run) * chunk >= min(n_req, n_iter) with
    n_req = log(1 - confidence) / log(1 - w^n_points), w the best inlier
    ratio over the valid matches (Hartley & Zisserman Alg. 4.5).

    Hypothesis h of the loop takes the set that hypothesis h of the
    fixed-count fit takes from the same generator state, so the sets do not
    depend on where the loop stops; the stop test never leaves the device.
    Matches, valid and generator as `ransac_homography`: k pairs' fits are
    one cooperative launch, each pair stopping at its own bound.
    injected_samples: optional (ceil(n_iter / chunk) * chunk, n_points)
      int32 match indices (with a leading pair axis for k pairs) used
      instead of drawing, block after block, so that a test can feed the
      reference's per-block draws.
    n_points / transform: as `ransac_homography`.

    Returns (RansacResult, n_evaluated): n_evaluated () int32, (k,) for k
    pairs, is the number of hypotheses scored, a multiple of `chunk`, as a
    device tensor.
    """
    _check_transform(n_points, transform)
    draws = _draws(match1, generator, injected_samples, -(-n_iter // chunk) * chunk, n_points)
    res, n_eval, _ = ransac_adaptive(match1, match2, valid, tolerance, n_iter, chunk,
                                     confidence, transform=transform, **draws)
    return res, n_eval
