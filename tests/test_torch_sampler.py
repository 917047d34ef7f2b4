"""The port's bilinear sampler against the JAX package, on the CPU: kernel 5
in its homography form (`warp_homography`, the fine stage's warp) and its
grid form, kernel 11 (`grid_sample_backward`), the fine stage that warps by
a homography, and the launch path that every kernel shares.

The wrappers take their plain versions for CPU tensors, so these tests hold
the plain versions against JAX; the `gpu` tests hold the CUDA kernels
against the plain versions and skip without a card.
"""

import ctypes

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ransacflow_tpu.ops import homography as jhom
from ransacflow_tpu.ops import sampler as jsampler
from ransacflow_tpu.pipeline import fine as jfine
from ransacflow_tpu.pipeline import init_alignment_params as j_init_align
from ransacflow_tpu_torch import kernels
from ransacflow_tpu_torch.kernels import build, warp_sample as ws
from ransacflow_tpu_torch.models import convert
from ransacflow_tpu_torch.ops.grid import normalized_grid
from ransacflow_tpu_torch.pipeline import fine, fused

ATOL = 1e-5       # fp32 elementwise ops, same formulas, other libraries
ATOL_GRID = 1e-6  # a 3-term dot product and one divide per grid point
ATOL_MAPS = 1e-4  # the fine stage's outputs after ~20 convolutions


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def t(a):
    return torch.from_numpy(np.array(a))


def close(ours, ref, atol):
    np.testing.assert_allclose(ours.detach().cpu().numpy(), np.asarray(ref), atol=atol)


def _homographies(rng, kind):
    """(1, 3, 3) float32: the identity, a mild warp, or one that maps most
    of the grid past the source."""
    if kind == "identity":
        H = np.eye(3)
    elif kind == "warp":
        H = np.eye(3) + 0.05 * rng.randn(3, 3)
    else:
        H = np.array([[1.4, 0.1, 0.5], [-0.05, 1.3, -0.4], [0.05, -0.08, 1.0]])
    return H[None].astype(np.float32)


@pytest.mark.parametrize("kind", ["identity", "warp", "past"])
def test_warp_homography_ref_matches_jax(rng, kind):
    """The plain version's warp and grid against JAX's grid_sample of
    warp_grid; the identity's grid is exactly the linspace grid, +-1 on the
    border. The output is smaller than the source and of odd width."""
    src = rng.rand(1, 11, 14, 3).astype(np.float32)
    H = _homographies(rng, kind)
    warped, grid = ws.warp_homography_ref(t(src), t(H), (9, 13))
    j_grid = jhom.warp_grid(jnp.asarray(H), 9, 13)
    close(grid, j_grid, ATOL_GRID)
    close(warped, jsampler.grid_sample(jnp.asarray(src), j_grid), ATOL)
    if kind == "identity":
        assert torch.equal(grid, normalized_grid(9, 13, "cpu")[None])
        assert (grid[0, :, 0, 0] == -1).all() and (grid[0, :, -1, 0] == 1).all()
        assert (grid[0, 0, :, 1] == -1).all() and (grid[0, -1, :, 1] == 1).all()
    if kind == "past":
        assert (grid.abs() > 1).any(dim=-1).float().mean() > 0.2
        assert (warped == 0).all(dim=-1).any()


def test_warp_homography_takes_the_plain_version_on_cpu_and_raises_under_grad(rng):
    src = t(rng.rand(1, 8, 10, 3).astype(np.float32))
    H = t(_homographies(rng, "warp"))
    kernels.reset_launch_counts()
    for ours, ref in zip(ws.warp_homography(src, H, (6, 7)),
                         ws.warp_homography_ref(src, H, (6, 7))):
        torch.testing.assert_close(ours, ref, atol=0, rtol=0)
    assert set(kernels.launch_counts().values()) == {0}
    for a, b in ((src.clone().requires_grad_(), H), (src, H.clone().requires_grad_())):
        with pytest.raises(RuntimeError, match="no backward"):
            ws.warp_homography(a, b, (6, 7))
        with torch.no_grad():
            ws.warp_homography(a, b, (6, 7))


@pytest.fixture(scope="module")
def nets():
    ja = j_init_align(jax.random.PRNGKey(1))
    return ja, convert.alignment_params_from_tree(ja, "cpu")


@pytest.mark.parametrize("cycle_match", [True, False])
def test_pred_flow_mask_homography_matches_jax(rng, nets, cycle_match):
    """The fine stage warped by H against JAX's pred_flow_mask at
    warp_grid(H), on a 64x64 target; the warped source comes back too."""
    ja, align = nets
    src = rng.rand(1, 64, 64, 3).astype(np.float32)
    tgt = rng.rand(1, 64, 64, 3).astype(np.float32)
    H = (np.eye(3) + 0.05 * rng.randn(3, 3)).astype(np.float32)[None]
    flow_coarse = jhom.warp_grid(jnp.asarray(H), 64, 64)
    featt = jfine.fine_features(ja, jnp.asarray(tgt))
    ref = jfine.pred_flow_mask(ja, jnp.asarray(src), featt, flow_coarse,
                               cycle_match=cycle_match)
    ours = fine.pred_flow_mask_homography(align, t(src), t(featt), t(H), (64, 64),
                                          cycle_match=cycle_match)
    assert ours["match"].shape == (1, 64, 64)  # the batch axis kept, B = 1
    ours["match"] = ours["match"][0]
    for key in ("flow", "match", "flow_down8", "match_down8"):
        assert ours[key].shape == ref[key].shape
        close(ours[key], ref[key], ATOL_MAPS)
    close(ours["warped"], jsampler.grid_sample(jnp.asarray(src), flow_coarse), ATOL)


def test_fine_gate_warps_once_by_homography(rng, monkeypatch):
    """`fused._fine_with_gate_batch` runs the fine stage through one
    `warp_homography` call and no grid-form warp; a failed RANSAC warps by
    the identity and hands back the identity grid."""
    from ransacflow_tpu_torch.pipeline import init_alignment_params

    align = init_alignment_params(torch.Generator().manual_seed(1), "cpu")
    calls = []

    def counted(src, H, out_hw):
        calls.append(H.clone())
        return ws.warp_homography(src, H, out_hw)

    def forbidden(*args):
        raise AssertionError("the fine stage warped at a prebuilt grid")

    monkeypatch.setattr(fine, "warp_homography", counted)
    monkeypatch.setattr(fine, "warp_sample", forbidden)
    src = t(rng.rand(1, 48, 64, 3).astype(np.float32))
    tgt = t(rng.rand(1, 48, 64, 3).astype(np.float32))
    H = t((np.eye(3) + 0.05 * rng.randn(3, 3)).astype(np.float32))
    for found in (True, False):
        out = fused._fine_with_gate_batch(align, (src,), tgt, H[None], torch.tensor([found]),
                                          torch.tensor([7]), True, 7)
        torch.testing.assert_close(calls[-1][0], H if found else torch.eye(3))
        if not found:
            assert torch.equal(out["flow"][0], normalized_grid(48, 64, "cpu")[None])
            assert (out["match"] == 0).all()
    assert len(calls) == 2


def _grid_with_border(rng, b, h, w):
    """(b, h, w, 2) grids: the identity (its border exactly on +-1) and
    warps that reach past the image."""
    H = np.stack([np.eye(3)] + [np.eye(3) + 0.15 * rng.randn(3, 3) for _ in range(b - 1)])
    return np.array(jhom.warp_grid(jnp.asarray(H.astype(np.float32)), h, w))


@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("need_image", [True, False])
def test_grid_sample_backward_matches_jax_vjp(rng, channels, need_image):
    """K11's plain version against `jax.vjp` of JAX's grid_sample (its
    custom VJP), grids on +-1 and outside included. The grid cotangent is
    scaled by (W - 1) / 2: held relative to its largest magnitude."""
    img = rng.rand(3, 9, 12, channels).astype(np.float32)
    grid = _grid_with_border(rng, 3, 7, 10)
    g = rng.randn(3, 7, 10, channels).astype(np.float32)
    _, vjp = jax.vjp(jsampler.grid_sample, jnp.asarray(img), jnp.asarray(grid))
    j_dimg, j_dgrid = vjp(jnp.asarray(g))
    d_img, d_grid = ws.grid_sample_backward(t(img), t(grid), t(g), need_image)
    close(d_grid, j_dgrid, ATOL * max(1.0, float(jnp.abs(j_dgrid).max())))
    if need_image:
        close(d_img, j_dimg, ATOL)
    else:
        assert d_img is None


class _FakeFn:
    """A ctypes function stand-in: counts how often it is bound."""

    def __init__(self):
        self.bound = 0
        self.calls = []
        self.result = 0

    def __setattr__(self, name, value):
        if name == "argtypes":
            self.__dict__["bound"] += 1
        self.__dict__[name] = value

    def __call__(self, *args):
        self.calls.append(args)
        return self.result


class _FakeLibrary:
    def __init__(self):
        self.fn = _FakeFn()
        self.lookups = 0

    def __getattr__(self, name):  # the library's symbols
        if name != "rf_fake":
            raise AttributeError(name)
        self.lookups += 1
        return self.fn

    def rf_error_string(self, err):
        return b"a fake error"


def test_kernel_binds_once_and_counts_launches(monkeypatch):
    """`Kernel` resolves its symbol and sets argtypes on its first call
    only, passes pointers as ints, counts the launches that succeeded and
    raises on a CUDA error."""
    lib = _FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    kernel = build.Kernel("rf_fake", [ctypes.c_void_p, ctypes.c_int])
    x = torch.zeros(4)
    assert isinstance(build.ptr(x), int) and build.ptr(x) == x.data_ptr()
    dev = torch.device("cuda", 0)
    kernel(dev, build.ptr(x), 4)
    kernel(dev, 0, 5)
    assert lib.lookups == 1 and lib.fn.bound == 1
    assert lib.fn.restype is ctypes.c_int
    assert lib.fn.calls == [(x.data_ptr(), 4), (0, 5)]
    assert kernel.launches == 2
    lib.fn.result = 700
    with pytest.raises(RuntimeError, match="rf_fake: CUDA error 700: a fake error"):
        kernel(dev, 0, 6)
    assert kernel.launches == 2 and lib.fn.bound == 1


# --- on the card -----------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("src_hw,out_hw", [((48, 64), (48, 64)), ((37, 53), (29, 41)),
                                           ((60, 80), (31, 7))])
def test_warp_homography_kernel_on_card(cuda, rng, channels, src_hw, out_hw):
    """The homography form against warp_grid + F.grid_sample: image within
    1e-5, grid within 1e-6, the identity's grid exactly the linspace grid;
    one launch a call; widths that are not multiples of 4 included."""
    src = t(rng.rand(2, *src_hw, channels).astype(np.float32)).to(cuda)
    for kind in ("identity", "warp", "past"):
        H = t(np.concatenate([_homographies(rng, kind)] * 2)).to(cuda)
        kernels.reset_launch_counts()
        warped, grid = ws.warp_homography(src, H, out_hw)
        assert kernels.launch_counts()["warp_homography"] == 1
        warped_r, grid_r = ws.warp_homography_ref(src, H, out_hw)
        torch.testing.assert_close(grid, grid_r, atol=ATOL_GRID, rtol=0)
        torch.testing.assert_close(warped, warped_r, atol=ATOL, rtol=0)
        if kind == "identity":
            assert torch.equal(grid, normalized_grid(*out_hw, cuda)[None].expand_as(grid))


@pytest.mark.gpu
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_warp_sample_tails_on_card(cuda, rng, channels):
    """The grid form with rows that are not multiples of 4 pixels, and a
    grid that is 8- but not 16-byte aligned (stored pixel by pixel); with
    no input requiring grad it launches without an autograd node."""
    img = t(rng.rand(2, 17, 23, channels).astype(np.float32)).to(cuda)
    for ho, wo in ((19, 21), (5, 3), (8, 64)):
        g = t(_grid_with_border(rng, 2, ho, wo)).to(cuda)
        shifted = torch.empty(g.numel() + 2, device=cuda)[2:]
        shifted.copy_(g.flatten())
        for grid in (g, shifted.view(g.shape)):
            kernels.reset_launch_counts()
            out = ws.warp_sample(img, grid)
            assert kernels.launch_counts()["warp_sample"] == 1 and out.grad_fn is None
            torch.testing.assert_close(out, ws.warp_sample_ref(img, grid), atol=ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_grid_sample_backward_paths_on_card(cuda, rng, channels):
    """K11 on a near-identity grid (every tile through shared memory) and on
    a random wide grid (every tile through global atomics) against
    F.grid_sample's autograd, both need_image values; the tile counts show
    the path. Shared and global fp32 atomics add in an order that changes
    from run to run: 1e-5 of the largest magnitude."""
    img = t(rng.rand(2, 128, 160, channels).astype(np.float32)).to(cuda)
    near = normalized_grid(100, 136, cuda)[None] + 0.01 * torch.randn(
        (2, 100, 136, 2), device=cuda)
    wide = 2 * torch.rand((2, 100, 136, 2), device=cuda) - 1
    for grid, path in ((near.contiguous(), 0), (wide, 1)):
        g = torch.randn((*grid.shape[:3], channels), device=cuda)
        for need_image in (True, False):
            ws.reset_tile_counts()
            kernels.reset_launch_counts()
            d_img, d_grid = ws.grid_sample_backward(img, grid, g, need_image)
            assert kernels.launch_counts()["grid_sample_bwd"] == 1
            r_img, r_grid = ws.grid_sample_backward_ref(img, grid, g, need_image)
            scale = max(1.0, r_grid.abs().max().item())
            torch.testing.assert_close(d_grid, r_grid, atol=ATOL * scale, rtol=0)
            counts = ws.tile_counts(cuda).tolist()
            if need_image:
                torch.testing.assert_close(d_img, r_img, atol=ATOL, rtol=0)
                assert counts[path] == 5 * 13 * 2 and counts[1 - path] == 0, counts
            else:
                assert d_img is None and counts == [0, 0]

