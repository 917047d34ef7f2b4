"""The port's two-view pose estimator (`ransacflow_tpu_torch/eval/pose.py`)
against OpenCV, the library behind the JAX YFCC metric
(`ransacflow_tpu/eval/yfcc.py:263-290`), on the CPU.

The solvers, the cheirality test and the inlier test are deterministic and
are held to cv2 on the same inputs. The RANSAC draws differ (a numpy
Generator against cv2's own RNG), so `estimate_pose` is held to the JAX
package's cv2-based `estimate_pose` by the pose error each reaches on the
same seeded scenes.
"""

import numpy as np
import pytest
import torch

from ransacflow_tpu_torch.eval import pose, yfcc

cv2 = pytest.importorskip("cv2")

N_MINIMAL = 60
N_END_TO_END = 30
THRESHOLD = 0.0005  # the YFCC harness's --threshold


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _scene(rng, n, noise=0.0, outliers=0.0):
    """n normalized correspondences of points 2-6 units in front of camera
    1, seen by camera 2 at (R, t): x2 ~ R X + t. The first outliers * n of
    camera 2's points are replaced by uniform noise. Returns (x1, x2, R,
    t)."""
    X = np.c_[rng.uniform(-1.5, 1.5, (n, 2)), rng.uniform(2, 6, n)]
    R = cv2.Rodrigues(rng.normal(size=3) * 0.15)[0]
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)
    Y = X @ R.T + t
    x1 = X[:, :2] / X[:, 2:] + noise * rng.normal(size=(n, 2))
    x2 = Y[:, :2] / Y[:, 2:] + noise * rng.normal(size=(n, 2))
    k = int(outliers * n)
    x2[:k] = rng.uniform(-0.5, 0.5, (k, 2))
    return x1, x2, R, t


def _blocks(E):
    E = np.asarray(E).reshape(-1, 3, 3)
    return E / np.linalg.norm(E, axis=(1, 2), keepdims=True)


def _up_to_sign(a, b):
    return min(np.abs(a - b).max(), np.abs(a + b).max())


def test_five_point_solutions_match_cv2():
    """On exactly 5 points cv2's RANSAC returns every solution of its
    minimal solver, stacked. The port's solution set has cv2's count and
    each of its solutions is one of cv2's within 1e-6 (unit Frobenius norm,
    up to sign). Conditioning filter: scenes whose 5x9 epipolar system has
    its smallest singular value under 1e-3 of its largest are skipped (a
    nearly rank-deficient system leaves the nullspace, and so every
    solution, ill-determined); at most a tenth may be skipped."""
    rng = np.random.default_rng(0)
    checked = 0
    for _ in range(N_MINIMAL):
        x1, x2, _, _ = _scene(rng, 5)
        rows = np.c_[x2[:, :1] * x1, x2[:, :1], x2[:, 1:] * x1, x2[:, 1:], x1, np.ones(5)]
        s = np.linalg.svd(rows, compute_uv=False)
        if s[-1] < 1e-3 * s[0]:
            continue
        checked += 1
        E, mask = cv2.findEssentialMat(x1, x2, method=cv2.RANSAC, threshold=THRESHOLD)
        ref = _blocks(E) if E is not None else np.zeros((0, 3, 3))
        ours = pose.five_point_essential(x1, x2)
        assert len(ours) == len(ref)
        for e in ours:
            assert min(_up_to_sign(e, r) for r in ref) <= 1e-6
        E_ours, mask_ours = pose.find_essential_mat(x1, x2, THRESHOLD, device="cpu")
        if E is None:
            assert E_ours is None
        else:
            assert E_ours.shape == E.shape and (mask_ours == mask).all()
    assert checked >= 0.9 * N_MINIMAL


def test_find_essential_mat_under_five_points_finds_none():
    x1, x2, _, _ = _scene(np.random.default_rng(1), 4)
    assert cv2.findEssentialMat(x1, x2, method=cv2.RANSAC, threshold=THRESHOLD) == (None, None)
    assert pose.find_essential_mat(x1, x2, THRESHOLD, device="cpu") == (None, None)


@pytest.mark.parametrize("outliers", [0.0, 0.3, 0.5])
def test_sampson_inlier_test_matches_cv2(outliers):
    """On cv2's own E, the float32 Sampson test gives cv2's mask, but for
    points whose error lies within 1e-6 relative of threshold^2 (the port
    sums its products in another order)."""
    x1, x2, _, _ = _scene(np.random.default_rng(2), 2000, 2e-4, outliers)
    E, mask = cv2.findEssentialMat(x1, x2, method=cv2.RANSAC, threshold=THRESHOLD)
    err = pose.sampson_errors(torch.as_tensor(E[None]), torch.as_tensor(x1),
                              torch.as_tensor(x2))[0].numpy()
    ours = err <= np.float32(THRESHOLD ** 2)
    near = np.abs(err / THRESHOLD ** 2 - 1) <= 1e-6
    assert ((ours == mask[:, 0].astype(bool)) | near).all()
    assert 0.9 * (1 - outliers) * 2000 <= ours.sum()


@pytest.mark.parametrize("case", ["true_E", "cv2_ransac", "no_mask"])
def test_recover_pose_matches_cv2(case):
    """cv2.recoverPose on the same E and mask: R and t within 1e-9, the
    count equal."""
    x1, x2, R, t = _scene(np.random.default_rng(3), 2000, 2e-4, 0.3)
    if case == "cv2_ransac":
        E, mask = cv2.findEssentialMat(x1, x2, method=cv2.RANSAC, threshold=THRESHOLD)
    else:
        E = (np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]]) @ R)  # [t]x R
        mask = (np.arange(2000) >= 600).astype(np.uint8)[:, None]
    if case == "no_mask":
        count, R_ref, t_ref, _ = cv2.recoverPose(E, x1, x2)
        ours = pose.recover_pose(E, x1, x2, device="cpu")
    else:
        count, R_ref, t_ref, _ = cv2.recoverPose(E, x1, x2, mask=mask.copy())
        ours = pose.recover_pose(E, x1, x2, mask, device="cpu")
    assert ours[0] == count
    np.testing.assert_allclose(ours[1], R_ref, atol=1e-9, rtol=0)
    np.testing.assert_allclose(ours[2], t_ref, atol=1e-9, rtol=0)
    np.testing.assert_allclose(R_ref, R, atol=2e-2)  # the scene's own pose


@pytest.mark.parametrize("n", [7, 8, 50, 2000])
def test_eight_point_fundamental_matches_cv2(n):
    """cv2.findFundamentalMat(..., FM_8POINT): within 1e-8 after
    normalization and sign; with exactly 7 points the same set of 7-point
    solutions."""
    x1, x2, _, _ = _scene(np.random.default_rng(4 + n), n, 2e-4)
    F, mask = cv2.findFundamentalMat(x1, x2, cv2.FM_8POINT)
    ours, ours_mask = pose.eight_point_fundamental(x1, x2)
    ref, got = _blocks(F), _blocks(ours)
    assert len(got) == len(ref) and (ours_mask == mask).all()
    for g in got:
        assert min(_up_to_sign(g, r) for r in ref) <= 1e-8
    assert pose.eight_point_fundamental(x1[:6], x2[:6]) == (None, None)


def test_update_num_iters_follows_the_confidence_bound():
    """log(1 - p) / log(1 - w^5), rounded, never above the current cap; 0
    once every point is an inlier (OpenCV's RANSACUpdateNumIters)."""
    assert pose.update_num_iters(0.0, 1000) == 0
    assert pose.update_num_iters(1.0, 1000) == 1000
    assert pose.update_num_iters(0.3, 1000) == round(np.log(1e-3) / np.log(1 - 0.7 ** 5))
    assert pose.update_num_iters(0.6, 1000) == 671
    assert pose.update_num_iters(0.6, 500) == 500


@pytest.mark.parametrize("blocks", [(1, 1), (3, 7), (64, 1024)])
def test_find_essential_mat_does_not_depend_on_the_block_size(monkeypatch, blocks):
    """The draws are read in order and the stop rule is applied between
    hypotheses, so any block size gives the same model and mask."""
    x1, x2, _, _ = _scene(np.random.default_rng(5), 500, 2e-4, 0.5)
    ref = pose.find_essential_mat(x1, x2, THRESHOLD, seed=9, device="cpu")
    monkeypatch.setattr(pose, "FIRST_BLOCK", blocks[0])
    monkeypatch.setattr(pose, "MAX_BLOCK", blocks[1])
    got = pose.find_essential_mat(x1, x2, THRESHOLD, seed=9, device="cpu")
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


def test_draw_subsets_are_distinct_and_uniform():
    sets = pose.draw_subsets(np.random.default_rng(6), 7, 20000)
    assert ((np.sort(sets, axis=1)[:, 1:] != np.sort(sets, axis=1)[:, :-1]).all())
    assert sets.min() == 0 and sets.max() == 6
    freq = np.bincount(sets.ravel(), minlength=7) / sets.size
    np.testing.assert_allclose(freq, 1 / 7, atol=0.01)


def test_estimate_pose_matches_cv2_end_to_end():
    """30 seeded scenes of 2,000 points, noise 2e-4, 0-50% outliers: the
    port's max(R, t) error is within 1 degree of the cv2-based JAX
    estimate_pose's on each scene, and Acc@5/10/15/20 over the set are
    equal."""
    from ransacflow_tpu.eval import yfcc as j_yfcc

    rng = np.random.default_rng(7)
    ours, ref = [], []
    for k in range(N_END_TO_END):
        x1, x2, R, t = _scene(rng, 2000, 2e-4, 0.5 * k / (N_END_TO_END - 1))
        for out, fn in ((ours, lambda: yfcc.estimate_pose(x1, x2, threshold=THRESHOLD, seed=k,
                                                           device="cpu")),
                        (ref, lambda: j_yfcc.estimate_pose(x1, x2, threshold=THRESHOLD))):
            est = fn()
            out.append(max(yfcc.pose_error(R, t, *est)) if est is not None else 180.0)
    np.testing.assert_allclose(ours, ref, atol=1.0, rtol=0)
    for th in (5, 10, 15, 20):
        assert (np.array(ours) < th).mean() == (np.array(ref) < th).mean()


@pytest.mark.parametrize("use_ransac", [True, False])
def test_estimate_pose_degenerate_inputs(use_ransac):
    """tests/test_eval.py's degenerate cases: identical points, exactly
    collinear points and fewer than 5 points give None or a pose, and never
    raise."""
    p = np.tile(np.array([[0.1, 0.2]]), (10, 1))
    result = yfcc.estimate_pose(p, p.copy(), use_ransac=use_ransac, device="cpu")
    assert result is None or len(result) == 2
    t = np.linspace(0, 1, 10)
    col1 = np.stack([t, t], axis=1)
    col2 = np.stack([t + 0.1, t], axis=1)
    result = yfcc.estimate_pose(col1, col2, use_ransac=use_ransac, device="cpu")
    assert result is None or len(result) == 2
    assert yfcc.estimate_pose(col1[:4], col2[:4], use_ransac=use_ransac,
                              device="cpu") is None


@pytest.mark.parametrize("call", ["find_essential_mat", "recover_pose", "estimate_pose"])
def test_pose_helpers_have_no_default_device(call):
    """The port's entry points take their device from the caller: the pose
    helpers raise TypeError when it is left out."""
    x1, x2, _, _ = _scene(np.random.default_rng(8), 50)
    calls = {"find_essential_mat": lambda: pose.find_essential_mat(x1, x2, THRESHOLD),
             "recover_pose": lambda: pose.recover_pose(np.eye(3), x1, x2),
             "estimate_pose": lambda: yfcc.estimate_pose(x1, x2, threshold=THRESHOLD)}
    with pytest.raises(TypeError, match="device"):
        calls[call]()
