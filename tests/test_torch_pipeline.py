"""Parity of the PyTorch port's serving path with the JAX package, on the CPU.

The slice as a whole: `fused_align` on one 64x64 pair with 2 scales and 256
hypotheses, fed JAX's own RANSAC draws (`_sample_minimal_sets` under the
pair's key, mapped through `argsort(~valid, stable=True)`) as
`injected_samples`, against JAX `fused_align` with that key.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ransacflow_tpu.models import init_resnet50_layer3 as j_init_resnet
from ransacflow_tpu.ops.homography import warp_grid as j_warp_grid
from ransacflow_tpu.ops.ransac import _sample_minimal_sets
from ransacflow_tpu.pipeline import init_alignment_params as j_init_align
from ransacflow_tpu.pipeline import fine as jfine
from ransacflow_tpu.pipeline import fused as jfused
from ransacflow_tpu_torch.models import convert
from ransacflow_tpu_torch.pipeline import fine, fused
from ransacflow_tpu_torch.utils.image import pyramid_shapes, scale_list

N_ITER = 256
# fp32 conv stacks in two libraries; the flow and matchability outputs sit
# after ~20 convolutions, H21 after the 4-point solve
ATOL_H21 = 1e-4
ATOL_MAPS = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def nets():
    jr = j_init_resnet(jax.random.PRNGKey(0))
    ja = j_init_align(jax.random.PRNGKey(1))
    return jr, ja, convert.resnet50_layer3_from_tree(jr, "cpu"), \
        convert.alignment_params_from_tree(ja, "cpu")


def t(a):
    return torch.from_numpy(np.array(a))


def close(ours, ref, atol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=atol)


def test_pyramid_shapes_match_bench():
    import bench

    assert pyramid_shapes() == bench.pyramid_shapes()
    assert pyramid_shapes(min_size=240, aspect=(240, 320), nb_scale=3) == \
        bench.pyramid_shapes(min_size=240, aspect=(240, 320), nb_scale=3)
    from ransacflow_tpu.utils.image import scale_list as j_scale_list

    assert scale_list(7, 2.0) == j_scale_list(7, 2.0)


def test_device_pyramid(rng):
    img = rng.rand(1, 96, 128, 3).astype(np.float32)
    shapes = [(96, 128), (64, 96), (48, 64), (128, 160), (96, 80)]
    for ours, ref in zip(fused.device_pyramid(t(img), shapes),
                         jfused.device_pyramid(jnp.asarray(img), shapes)):
        assert ours.shape == ref.shape
        close(ours, ref, atol=1e-5)


# (cycle_match, out_hw): out_hw None keeps the cases' first ids; the others
# compose above the 64 x 64 coarse grid (KITTI's second pass) and below it
FINE_CASES = [pytest.param(c, None, id=str(c)) for c in (True, False)] + [
    pytest.param(c, hw, id=f"{c}-{hw[0]}x{hw[1]}")
    for c in (True, False) for hw in ((75, 83), (40, 56))]


@pytest.mark.parametrize("cycle_match,out_hw", FINE_CASES)
def test_pred_flow_mask(rng, nets, cycle_match, out_hw):
    _, ja, _, align = nets
    src = rng.rand(1, 64, 64, 3).astype(np.float32)
    tgt = rng.rand(1, 64, 64, 3).astype(np.float32)
    H = (np.eye(3) + 0.05 * rng.randn(3, 3)).astype(np.float32)
    flow_coarse = j_warp_grid(jnp.asarray(H)[None], 64, 64)
    featt = jfine.fine_features(ja, jnp.asarray(tgt))
    close(fine.fine_features(align, t(tgt)), featt, atol=1e-5)
    ref = jfine.pred_flow_mask(ja, jnp.asarray(src), featt, flow_coarse,
                               cycle_match=cycle_match, out_hw=out_hw)
    ours = fine.pred_flow_mask(align, t(src), t(featt), t(flow_coarse),
                               cycle_match=cycle_match, out_hw=out_hw)
    assert ours["match"].shape == (out_hw or (64, 64))
    for key in ("flow", "match", "flow_down8", "match_down8"):
        assert ours[key].shape == ref[key].shape
        close(ours[key], ref[key], atol=ATOL_MAPS)


@pytest.mark.gpu
def test_fine_pass_launches_one_head_epilogue(rng):
    """One fine pass on the card (`_after_warp`, from the homography form)
    runs its three head epilogues as one launch of kernel 7, and returns
    the maps of the same pass on the CPU (cuDNN and the CPU sum the
    convolutions in other orders; fp32, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ransacflow_tpu_torch import kernels
    from ransacflow_tpu_torch.device import full_fp32

    src, tgt = (rng.rand(1, 64, 64, 3).astype(np.float32) for _ in range(2))
    H = (np.eye(3) + 0.05 * rng.randn(3, 3)).astype(np.float32)[None]
    outs = {}
    for device in ("cpu", "cuda"):
        align = convert.init_alignment_params(torch.Generator().manual_seed(1), device)
        featt = fine.fine_features(align, t(tgt).to(device))
        kernels.reset_launch_counts()
        with full_fp32():
            outs[device] = fine.pred_flow_mask_homography(
                align, t(src).to(device), featt, t(H).to(device), (64, 64))
    counts = kernels.launch_counts()
    assert counts["head_epilogues"] == 1 and counts["compose_tail"] == 1
    for key in ("flow_down8", "match_down8"):
        close(outs["cuda"][key].cpu(), outs["cpu"][key], atol=ATOL_MAPS)


def _pair(rng):
    pyr = (rng.rand(1, 64, 64, 3).astype(np.float32),
           rng.rand(1, 32, 32, 3).astype(np.float32))
    return pyr, rng.rand(1, 64, 64, 3).astype(np.float32)


def test_coarse_match(rng, nets):
    jr, _, resnet, _ = nets
    pyr, tgt = _pair(rng)
    ref = jfused._coarse_match(jr, tuple(map(jnp.asarray, pyr)), jnp.asarray(tgt))
    with torch.no_grad():
        ours = [x[0] for x in fused._coarse_match_batch(resnet, tuple(map(t, pyr)), t(tgt))]
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]))
    assert ours[2].any()
    close(ours[0], ref[0], atol=0)
    close(ours[1], ref[1], atol=0)


def test_fused_align_matches_jax(rng, nets):
    """The whole slice, one pair, the same weights, inputs and draws."""
    jr, ja, resnet, align = nets
    pyr, tgt = _pair(rng)
    jpyr = tuple(map(jnp.asarray, pyr))
    key = jax.random.PRNGKey(7)
    _, _, valid = jfused._coarse_match(jr, jpyr, jnp.asarray(tgt))
    raw, _ = _sample_minimal_sets(key, jnp.sum(valid.astype(jnp.int32)), 4, N_ITER)
    order = jnp.argsort(~valid, stable=True)
    samples = np.asarray(order[raw]).astype(np.int32)

    ref = jfused.fused_align(jr, ja, jpyr, jnp.asarray(tgt), key, n_iter=N_ITER)
    ours = fused.fused_align(resnet, align, tuple(map(t, pyr)), t(tgt),
                             n_iter=N_ITER, injected_samples=t(samples))
    assert bool(ours["found"]) == bool(ref["found"]) is True
    assert int(ours["num_inliers"]) == int(ref["num_inliers"])
    close(ours["H21"], ref["H21"], atol=ATOL_H21)
    for key_ in ("flow", "match", "flow_down8", "match_down8"):
        assert ours[key_].shape == ref[key_].shape
        close(ours[key_], ref[key_], atol=ATOL_MAPS)


def test_fused_align_batch_is_a_loop_over_pairs(rng, nets):
    _, _, resnet, align = nets
    pairs = [_pair(rng) for _ in range(2)]
    pyramids = tuple(t(np.stack([p[0][i] for p in pairs])) for i in range(2))
    targets = t(np.stack([p[1] for p in pairs]))
    out = fused.fused_align_batch(resnet, align, pyramids, targets,
                                  torch.Generator().manual_seed(3), n_iter=64)
    assert out["H21"].shape == (2, 3, 3) and out["flow"].shape == (2, 1, 64, 64, 2)
    gen = torch.Generator().manual_seed(3)
    for k, (pyr, tgt) in enumerate(pairs):
        one = fused.fused_align(resnet, align, tuple(map(t, pyr)), t(tgt), gen,
                                n_iter=64)
        for key_, v in one.items():
            torch.testing.assert_close(out[key_][k], v)


def test_fused_align_gates_a_failed_ransac(rng, nets):
    """No valid match: identity H21, zero matchability, identity flow."""
    _, _, resnet, align = nets
    pyr, tgt = _pair(rng)
    res = fused.ransac_homography(torch.zeros(1, 16, 3), torch.zeros(1, 16, 3),
                                  torch.zeros(1, 16, dtype=torch.bool), 0.05, n_iter=8,
                                  generator=torch.Generator().manual_seed(0))
    out = {key: v[0] for key, v in fused._fine_with_gate_batch(
        align, tuple(map(t, pyr)), t(tgt), res.H21, res.found, res.num_inliers,
        cycle_match=True, kernel_size=7).items()}
    assert not bool(out["found"])
    torch.testing.assert_close(out["H21"], torch.eye(3))
    assert (out["match"] == 0).all() and (out["flow_down8"] == 0).all()
    close(out["flow"], j_warp_grid(jnp.eye(3)[None], 64, 64), atol=1e-6)
