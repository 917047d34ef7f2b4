"""Parity of the PyTorch port's opt-in fast modes and public aligner with the
JAX package, on the CPU.

The anchor-stride feature resample (kernel 12's plain version), relaxed
reciprocity in mutual matching (kernel 2's plain epilogue), `_coarse_match`
and `fused_align` in those modes under JAX's own RANSAC draws, the
`CoarseAligner` anchor bank and its loops, and `RansacFlowAligner` /
`cli.align` against JAX's aligner with JAX's draws replayed. Weights are
JAX's init trees carried over by `convert`; inputs are numpy-seeded.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from ransacflow_tpu.models import init_resnet50_layer3 as j_init_resnet
from ransacflow_tpu.ops import matching as jmatch
from ransacflow_tpu.ops import ransac as jransac
from ransacflow_tpu.pipeline import CoarseAligner as JCoarseAligner
from ransacflow_tpu.pipeline import RansacFlowAligner as JRansacFlowAligner
from ransacflow_tpu.pipeline import coarse as jcoarse
from ransacflow_tpu.pipeline import fused as jfused
from ransacflow_tpu.pipeline import init_alignment_params as j_init_align
from ransacflow_tpu_torch import kernels
from ransacflow_tpu_torch.cli import align as cli_align
from ransacflow_tpu_torch.kernels import anchor_resample
from ransacflow_tpu_torch.kernels.anchor_resample import (
    anchor_resample_bank,
    anchor_resample_bank_ref,
    anchor_resample_feats,
    anchor_resample_feats_ref,
)
from ransacflow_tpu_torch.kernels.matching import mutual_argmax, mutual_argmax_ref
from ransacflow_tpu_torch.models import convert
from ransacflow_tpu_torch.ops import matching
from ransacflow_tpu_torch.pipeline import (
    CoarseAligner, RansacFlowAligner, bank, coarse, fused, multihomo)
from ransacflow_tpu_torch.utils.image import pyramid_shapes

ATOL_H21 = 1e-4   # fp32 4-point solves in two libraries
ATOL_MAPS = 1e-4  # fp32 conv stacks in two libraries (~20 convolutions)
# the four resamples of a serving pair at stride 3 (anchors 0, 3, 6)
SERVING_RESAMPLES = [((60, 80), (50, 66)), ((30, 40), (40, 53)), ((30, 40), (25, 33)),
                     ((15, 20), (20, 26))]


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


# -- kernel 12: the anchor resample -------------------------------------------


def _jax_resample(fmap, fh, fw):
    """`ransacflow_tpu/pipeline/coarse.py:69-78` `_anchor_resample_feats`."""
    return np.asarray(jcoarse._anchor_resample_feats(jnp.asarray(fmap), fh, fw))


@pytest.mark.parametrize("shapes,channels", [
    *[(s, 1024) for s in SERVING_RESAMPLES],
    (((13, 17), (7, 9)), 16),     # downscale: the antialiased kernel
    (((7, 9), (13, 17)), 16),     # upscale
    (((9, 11), (9, 11)), 16),     # identity: the normalization alone
    (((9, 11), (9, 7)), 16),      # one axis only
], ids=lambda v: str(v))
def test_anchor_resample_ref_matches_jax(rng, shapes, channels):
    (h, w), (fh, fw) = shapes
    fmap = (3 * rng.randn(1, h, w, channels)).astype(np.float32)
    ref = _jax_resample(fmap, fh, fw)
    ours = anchor_resample_feats(t(fmap), fh, fw)
    assert ours.shape == (fh * fw, channels)
    close(ours, ref, atol=1e-5)
    # the rows written in place into a larger bank, as the anchor bank does
    bank = torch.full((fh * fw + 3, channels), 7.0)
    anchor_resample_feats(t(fmap), fh, fw, out=bank[2:2 + fh * fw])
    torch.testing.assert_close(bank[2:2 + fh * fw], ours, atol=0, rtol=0)
    assert (bank[:2] == 7).all() and (bank[-1] == 7).all()


def test_interpolate_antialias_agrees_with_jax_bilinear(rng):
    """`F.interpolate(mode='bilinear', antialias=True)` computes JAX's
    bilinear resize at the serving resamples (to 1e-6 here), so it and
    `F.normalize` are kernel 12's library-call yardstick; the port never
    calls it."""
    for (h, w), (fh, fw) in SERVING_RESAMPLES:
        fmap = rng.randn(1, h, w, 32).astype(np.float32)
        lib = F.interpolate(t(fmap).permute(0, 3, 1, 2), size=(fh, fw), mode="bilinear",
                            align_corners=False, antialias=True)
        lib = F.normalize(lib, dim=1).permute(0, 2, 3, 1).reshape(fh * fw, 32)
        close(lib, _jax_resample(fmap, fh, fw), atol=1e-5)


def _serving_anchor_maps(rng, stride, channels=8):
    """The 7-scale serving pyramid's shapes, JAX's nearest anchor of each
    scale (`ransacflow_tpu/pipeline/fused.py:105-111`) and numpy-seeded
    pre-normalization maps of the anchors at their grids."""
    shapes = pyramid_shapes()
    anchors = list(range(0, len(shapes), stride))
    log_scale = [0.5 * np.log(float(h * w)) for h, w in shapes]
    nearest = [min(anchors, key=lambda a: abs(log_scale[a] - log_scale[j]))
               for j in range(len(shapes))]
    maps = {i: (3 * rng.randn(1, shapes[i][0] // 16, shapes[i][1] // 16, channels)
                ).astype(np.float32) for i in sorted(set(nearest))}
    return shapes, nearest, maps


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_anchor_resample_bank_ref_matches_jax(rng, stride):
    """K12's bank: every scale's rows of its nearest anchor's map, resized
    where the grid differs and L2-normalized, concatenated in scale order
    (`ransacflow_tpu/pipeline/fused.py:105-120`). Stride 1: all identity."""
    shapes, nearest, maps = _serving_anchor_maps(rng, stride)
    ref = np.concatenate([_jax_resample(maps[i], h // 16, w // 16)
                          for (h, w), i in zip(shapes, nearest)])
    tmaps = {i: t(m) for i, m in maps.items()}
    for fn in (anchor_resample_bank_ref, anchor_resample_bank):
        ours = fn(tmaps, shapes, nearest)
        assert ours.shape == (1,) + ref.shape  # the maps' pair axis, k = 1
        close(ours[0], ref, atol=1e-5)
    assert nearest == bank.nearest_anchors(shapes, stride)


def _walk_bank_plan(plan, srcs, channels):
    """The bank that K12's launch writes from `plan`, each block walked in
    `order` exactly as the kernel indexes it: the descriptor table, the
    packed taps and spans, the bank offsets. Every row is written once."""
    meta = {f: plan["meta"][:, k] for k, f in enumerate(anchor_resample.META)}
    starts, counts, weights, spans = (torch.from_numpy(plan[k]) for k in
                                      ("starts", "counts", "weights", "spans"))
    bank = torch.full((plan["n_cells"], channels), float("nan"))
    written = torch.zeros(plan["n_cells"], dtype=torch.int32)

    def put(cell, v):
        bank[cell] = v / torch.sqrt((v * v).sum()).clamp_min(1e-12)
        written[cell] += 1

    for job in plan["order"].tolist():
        s, b = job >> 24, job & 0xFFFFFF
        m = {f: int(v[s]) for f, v in meta.items()}
        rows = srcs[s].reshape(-1, channels)  # (h * w, C), channels last
        if m["identity"]:
            for local in range(b * anchor_resample.TILE, (b + 1) * anchor_resample.TILE):
                if local < m["fh"] * m["fw"]:
                    put(m["cell0"] + local, rows[local])
            continue
        y, tx = divmod(b, m["tiles_x"])
        xa, n_span = spans[m["span_idx"] + 2 * tx:m["span_idx"] + 2 * tx + 2].tolist()
        r0, nr = int(starts[m["row_idx"] + y]), int(counts[m["row_idx"] + y])
        wr = weights[m["row_w"] + y * m["row_t"]:][:nr]
        stage = torch.zeros((n_span, channels))
        for i in range(nr):  # row taps in tap order
            stage += wr[i] * rows[(r0 + i) * m["w"] + xa:(r0 + i) * m["w"] + xa + n_span]
        for x in range(tx * anchor_resample.TILE, (tx + 1) * anchor_resample.TILE):
            if x >= m["fw"]:
                break
            x0, nc = int(starts[m["col_idx"] + x]) - xa, int(counts[m["col_idx"] + x])
            wc = weights[m["col_w"] + x * m["col_t"]:][:nc]
            acc = torch.zeros(channels)
            for j in range(nc):
                acc += wc[j] * stage[x0 + j]
            put(m["cell0"] + y * m["fw"] + x, acc)
    assert (written == 1).all()
    return bank


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_anchor_bank_plan_walked_as_the_kernel(rng, stride):
    """The plan that K12's one launch reads, walked by plain torch exactly as
    the kernel indexes it, gives `anchor_resample_bank_ref`; the resampled
    tiles spread among the identity ones, and a tile stages at most 11 input
    columns (44 KB of shared memory at C = 1024)."""
    shapes, nearest, maps = _serving_anchor_maps(rng, stride)
    srcs = [t(maps[i]) for i in nearest]
    grids = [(h // 16, w // 16) for h, w in shapes]
    plan = anchor_resample.bank_plan([tuple(m.shape[1:3]) for m in srcs], grids)
    ours = _walk_bank_plan(plan, srcs, 8)
    ref = anchor_resample_bank_ref({i: t(m) for i, m in maps.items()}, shapes, nearest)[0]
    torch.testing.assert_close(ours, ref, atol=1e-6, rtol=0)
    identity = plan["meta"][:, anchor_resample.META.index("identity")]
    kinds = [int(identity[job >> 24]) for job in plan["order"].tolist()]
    if 0 < sum(kinds) < len(kinds):
        assert kinds[0] == 0 and 0 < sum(kinds[:len(kinds) // 2]) < len(kinds) // 2
    assert plan["max_span"] <= 11


def test_anchor_resample_bank_caps_its_scales(rng):
    """At most MAX_SCALES scales (the kernel's parameter table), on any
    device, and as many anchors as scales."""
    fmap = t(rng.randn(1, 4, 5, 8).astype(np.float32))
    n = anchor_resample.MAX_SCALES + 1
    with pytest.raises(ValueError, match="scales"):
        anchor_resample_bank({0: fmap}, [(64, 80)] * n, [0] * n)
    with pytest.raises(ValueError, match="scales"):
        anchor_resample_bank({0: fmap}, [(64, 80)] * 2, [0])
    assert anchor_resample_bank({0: fmap}, [(64, 80)] * (n - 1), [0] * (n - 1)).shape == \
        (1, (n - 1) * 20, 8)


# -- kernel 2: relaxed reciprocity --------------------------------------------


def _relax_case(rng, grid_h=5, grid_w=6, n_a=40, c=8):
    a = rng.randn(c, n_a).astype(np.float32)
    b = rng.randn(c, grid_h * grid_w).astype(np.float32)
    b[:, 7:13] = b[:, 1:7] + 0.05 * rng.randn(c, 6)  # near-duplicate rows split votes
    a /= np.linalg.norm(a, axis=0, keepdims=True)
    b /= np.linalg.norm(b, axis=0, keepdims=True)
    return a, b, grid_w


@pytest.mark.parametrize("relax_cells", [1, 2])
@pytest.mark.parametrize("masked", [False, True])
def test_relaxed_mutual_matching_matches_jax(rng, relax_cells, masked):
    a, b, grid_w = _relax_case(rng)
    valid_b = rng.rand(b.shape[1]) > 0.25 if masked else None
    ref = jmatch.mutual_matching(jnp.asarray(a), jnp.asarray(b),
                                 None if valid_b is None else jnp.asarray(valid_b),
                                 relax_cells=relax_cells, grid_w=grid_w)
    exact = jmatch.mutual_matching(jnp.asarray(a), jnp.asarray(b))
    for fn in (matching.mutual_matching_ref, matching.mutual_matching):
        ours = fn(t(a), t(b), None if valid_b is None else t(valid_b),
                  relax_cells=relax_cells, grid_w=grid_w)
        np.testing.assert_array_equal(ours.src_idx.numpy(), np.asarray(ref.src_idx))
        np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
        close(ours.score, ref.score, atol=1e-6)
    # relaxing keeps every exact match and adds some
    assert np.asarray(ref.valid).sum() > np.asarray(exact.valid).sum() or masked
    assert not (np.asarray(exact.valid) & ~np.asarray(ref.valid)).any() or masked
    with pytest.raises(ValueError, match="grid_w"):
        matching.mutual_matching(t(a), t(b), relax_cells=relax_cells)


def _planted_score():
    """A (6, 12) score on a 3 x 4 target grid: target 4 (row 1, col 0) is
    source 0's column best and source 0's row best is target 0, one row up
    (flat distance 4, cell distance 1); target 8 (row 2, col 0) is source
    1's column best and source 1's row best is target 7 (row 1, col 3):
    flat distance 1 across the row edge, cell distance 3."""
    s = np.random.RandomState(5).rand(6, 12).astype(np.float32) * 0.1
    s[0, 4], s[0, 0] = 0.9, 1.0
    s[1, 8], s[1, 7] = 0.9, 1.0
    s[2, 0] = s[3, 7] = 1.5  # targets 0 and 7 have other column bests
    return s


def _match_score(score, valid_b=None, relax_cells=0, grid_w=None):
    """Mutual matching whose score matrix is exactly `score`: featA =
    score.T against the identity bank."""
    n_b = score.shape[1]
    args = (score.T, np.eye(n_b, dtype=np.float32))
    ref = jmatch.mutual_matching(*map(jnp.asarray, args),
                                 None if valid_b is None else jnp.asarray(valid_b),
                                 relax_cells=relax_cells, grid_w=grid_w)
    ours = matching.mutual_matching(*map(t, args), None if valid_b is None else t(valid_b),
                                    relax_cells=relax_cells, grid_w=grid_w)
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(ours.src_idx.numpy(), np.asarray(ref.src_idx))
    return ours.valid.numpy()


@pytest.mark.parametrize("relax_cells,row_up,across_edge", [
    (0, False, False), (1, True, False), (2, True, False), (3, True, True)])
def test_relax_radius_counts_cells_not_flat_indices(relax_cells, row_up, across_edge):
    """A back-match one row away (flat distance grid_w) is one cell away; a
    back-match across the row edge (flat distance 1) is grid_w - 1 cells
    away."""
    valid = _match_score(_planted_score(), relax_cells=relax_cells,
                         grid_w=4 if relax_cells else None)
    assert valid[4] == row_up and valid[8] == across_edge


def test_relaxed_back_match_on_a_masked_cell_validates_its_neighbour():
    """Mirrored from the reference (ADVICE item 4): with validB and
    relax_cells, source 0's row scores are negative on every unmasked
    target, so its row argmax is the masked (zero-score) target 0; target 4,
    one row below, still validates against it."""
    s = -0.5 - np.random.RandomState(6).rand(6, 12).astype(np.float32)
    s[0, 4] = -0.1  # source 0 is target 4's column best
    valid_b = np.ones(12, bool)
    valid_b[0] = False
    assert _match_score(s, valid_b, relax_cells=1, grid_w=4)[4]
    assert not _match_score(s, valid_b)[4]  # exact reciprocity rejects it


# -- the serving path in the fast modes ---------------------------------------


def _blocky(rng, h, w):
    base = (rng.rand(h // 4, w // 4, 3) > 0.5).astype(np.float32)
    return np.kron(base, np.ones((4, 4, 1), np.float32))


def _pyramid_pair(rng):
    """A 5-scale pyramid of a blocky source (2x its target's size down to
    half) and a target that is its mid scale shifted by one cell."""
    shapes = pyramid_shapes(min_size=96, aspect=(96, 128), nb_scale=5, scale_r=2.0)
    src = _blocky(rng, *shapes[0])[None]
    pyr = fused.device_pyramid(t(src), shapes)
    tgt = np.roll(pyr[len(shapes) // 2].numpy(), (16, 16), axis=(1, 2))
    return tuple(p.numpy() for p in pyr), tgt


@pytest.mark.parametrize("anchor_stride,relax_cells", [(2, 0), (2, 1), (3, 0), (3, 1)])
def test_coarse_match_fast_modes_match_jax(rng, nets, anchor_stride, relax_cells):
    jr, _, resnet, _ = nets
    pyr, tgt = _pyramid_pair(rng)
    ref = jfused._coarse_match(jr, tuple(map(jnp.asarray, pyr)), jnp.asarray(tgt),
                               anchor_stride=anchor_stride, relax_cells=relax_cells)
    with torch.no_grad():
        ours = [x[0] for x in fused._coarse_match_batch(resnet, tuple(map(t, pyr)), t(tgt),
                                                        anchor_stride=anchor_stride,
                                                        relax_cells=relax_cells)]
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]))
    assert ours[2].sum() > 10
    close(ours[0], ref[0], atol=0)
    close(ours[1], ref[1], atol=0)


def test_nearest_anchor_ties_go_to_the_first():
    shapes = [(64, 64), (32, 32), (16, 16)]  # scale 1 is as far from 0 as from 2
    assert bank.nearest_anchors(shapes, 2) == [0, 0, 2]
    assert bank.nearest_anchors(shapes, 1) == [0, 1, 2]


def _reference_block_draws(key, valid, n_iter, chunk):
    """JAX's per-block minimal sets of `ransac_homography_adaptive` under
    `key`, as match indices: block i draws under fold_in(key, i)."""
    n_valid = jnp.sum(jnp.asarray(valid).astype(jnp.int32))
    order = np.argsort(~np.asarray(valid), kind="stable")
    blocks = []
    for i in range(-(-n_iter // chunk)):
        raw, _ = jransac._sample_minimal_sets(jax.random.fold_in(key, i), n_valid, 4, chunk)
        blocks.append(order[np.asarray(raw)])
    return np.concatenate(blocks).astype(np.int32)


@pytest.mark.parametrize("adaptive_chunk", [0, 128])
def test_fused_align_fast_modes_match_jax(rng, nets, adaptive_chunk):
    """The whole slice in anchor + relaxed mode, fixed and adaptive RANSAC,
    under JAX's own draws."""
    jr, ja, resnet, align = nets
    pyr, tgt = _pyramid_pair(rng)
    jpyr = tuple(map(jnp.asarray, pyr))
    key = jax.random.PRNGKey(7)
    n_iter, kw = 512, dict(anchor_stride=3, relax_cells=1)
    _, _, valid = jfused._coarse_match(jr, jpyr, jnp.asarray(tgt), **kw)
    if adaptive_chunk:
        samples = _reference_block_draws(key, np.asarray(valid), n_iter, adaptive_chunk)
    else:
        raw, _ = jransac._sample_minimal_sets(key, jnp.sum(valid.astype(jnp.int32)), 4,
                                              n_iter)
        samples = np.asarray(jnp.argsort(~valid, stable=True)[raw]).astype(np.int32)
    ref = jfused.fused_align(jr, ja, jpyr, jnp.asarray(tgt), key, n_iter=n_iter,
                             adaptive_chunk=adaptive_chunk, **kw)
    kernels.reset_launch_counts()
    ours = fused.fused_align(resnet, align, tuple(map(t, pyr)), t(tgt), n_iter=n_iter,
                             injected_samples=t(samples), adaptive_chunk=adaptive_chunk,
                             **kw)
    assert set(kernels.launch_counts().values()) == {0}  # CPU: the plain versions
    assert bool(ours["found"]) == bool(ref["found"]) is True
    assert int(ours["num_inliers"]) == int(ref["num_inliers"])
    close(ours["H21"], ref["H21"], atol=ATOL_H21)
    for key_ in ("flow", "match", "flow_down8", "match_down8"):
        assert ours[key_].shape == ref[key_].shape
        close(ours[key_], ref[key_], atol=ATOL_MAPS)


def test_fused_align_batch_passes_the_modes(rng, nets):
    _, _, resnet, align = nets
    pyr, tgt = _pyramid_pair(rng)
    kw = dict(n_iter=64, adaptive_chunk=32, anchor_stride=3, relax_cells=1)
    out = fused.fused_align_batch(resnet, align, tuple(t(p[None]) for p in pyr),
                                  t(tgt[None]), torch.Generator().manual_seed(3), **kw)
    one = fused.fused_align(resnet, align, tuple(map(t, pyr)), t(tgt),
                            torch.Generator().manual_seed(3), **kw)
    for key_, v in one.items():
        torch.testing.assert_close(out[key_][0], v)


# -- CoarseAligner and the loops ----------------------------------------------

IMG = 256


def _translated_pair(rng, dx_px=32, dy_px=16):
    base = _blocky(rng, IMG, IMG)
    tgt = np.roll(base, (dy_px, dx_px), axis=(0, 1))
    to_pil = lambda a: Image.fromarray((a * 255).astype(np.uint8))  # noqa: E731
    h_true = np.array([[1, 0, -2 * dx_px / IMG], [0, 1, -2 * dy_px / IMG], [0, 0, 1]],
                      np.float32)
    return to_pil(base), to_pil(tgt), h_true


def _border_mask():
    m = np.ones((IMG, IMG), np.float32)
    m[48:-48, 48:-48] = 0
    return m


def _h_error(h_a, h_b, n=64):
    pts = np.random.RandomState(0).rand(n, 2) * 1.2 - 0.6
    p = np.concatenate([pts, np.ones((n, 1))], 1)
    qa, qb = p @ np.asarray(h_a, np.float64).T, p @ np.asarray(h_b, np.float64).T
    return np.abs(qa[:, :2] / qa[:, 2:] - qb[:, :2] / qb[:, 2:]).mean()


# 5 scales at stride 2: the anchors 0, 2 and 4 include the target's own
# scale. (Seeded trunks are not smooth across scales: on this pair the
# anchors 0 and 2 of 3 scales alone fit no model near the translation.)
FAST = dict(nb_scale=5, scale_r=1.2, n_iter=1024, min_size=IMG, anchor_stride=2,
            relax_cells=1)


@pytest.mark.parametrize("rematch", [False, True])
def test_coarse_aligner_fast_modes_match_jax(rng, nets, rematch):
    """The anchor bank from set_pair, then get_coarse with injected samples."""
    jr, _, resnet, _ = nets
    src, tgt, h_true = _translated_pair(rng)
    j = JCoarseAligner(jr, rematch_per_call=rematch, **FAST)
    ours = CoarseAligner(resnet, "cpu", rematch_per_call=rematch, **FAST)
    j.set_pair(src, tgt)
    ours.set_pair(src, tgt)
    close(ours._bank, j._bank, atol=1e-5)
    close(ours._coordsA, j._coordsA, atol=0)
    assert ours.num_cached_matches == j.num_cached_matches
    np.testing.assert_array_equal(ours._cached_src.numpy(), np.asarray(j._cached_src))
    mask = _border_mask()
    _, _, valid = ours._masked_matches(mask)
    cells = np.flatnonzero(valid.numpy())
    assert len(cells) > 10
    samples = rng.choice(cells, (256, 4)).astype(np.int32)
    h_ref, inl_ref = j.get_coarse(mask, injected_samples=samples)
    h, inl = ours.get_coarse(mask, injected_samples=samples)
    np.testing.assert_allclose(h, h_ref, atol=1e-6)
    np.testing.assert_array_equal(inl, inl_ref)
    assert _h_error(h, h_true) < 0.02


def test_device_loop_passes_relax_cells(rng, nets, monkeypatch):
    """The device-resident loop matches with the aligner's relax_cells (it
    used to run exact reciprocity), and agrees with the host loop."""
    _, _, resnet, align = nets
    src, tgt, h_true = _translated_pair(rng)
    c = CoarseAligner(resnet, "cpu", rematch_per_call=True, polish_fp64=False, **FAST)
    c.set_pair(src, tgt)
    kw = dict(max_coarse=2, mask_region_th=0.01, bg_mask=1.0 - _border_mask())
    host = multihomo.multi_homography_predict(c, align, **kw)
    seen = []
    match_masked = multihomo._match_masked

    def recording(*args):
        seen.append(args[6:])
        return match_masked(*args)

    monkeypatch.setattr(multihomo, "_match_masked", recording)
    fused_out = multihomo.multi_homography_predict_fused(c, align, **kw)
    assert seen and all(s == (1, IMG // 16) for s in seen)
    assert host is not None and fused_out is not None
    assert _h_error(fused_out["coarse_h"][0], h_true) < 0.02
    assert _h_error(fused_out["coarse_h"][0], host["coarse_h"][0]) < 0.01


# -- the public aligner and its CLI -------------------------------------------


def _replay_draws(monkeypatch):
    """Record JAX's fixed-count draws (order[raw] under its key) and replay
    them in the port's CoarseAligner."""
    recorded = []
    j_ransac, t_ransac = jcoarse.ransac_homography, coarse.ransac_homography

    def recording(key, m1, m2, valid, tolerance, n_iter=10000, **kw):
        raw, _ = jransac._sample_minimal_sets(key, jnp.sum(valid.astype(jnp.int32)), 4,
                                              n_iter)
        recorded.append(np.asarray(jnp.argsort(~valid, stable=True)[raw]).astype(np.int32))
        return j_ransac(key, m1, m2, valid, tolerance, n_iter=n_iter, **kw)

    def replaying(m1, m2, valid, tolerance, n_iter=10000, generator=None,
                  injected_samples=None):
        return t_ransac(m1, m2, valid, tolerance, n_iter=n_iter,
                        injected_samples=t(recorded.pop(0)))

    monkeypatch.setattr(jcoarse, "ransac_homography", recording)
    monkeypatch.setattr(coarse, "ransac_homography", replaying)
    return recorded


API = dict(nb_scale=5, n_iter=512, min_size=IMG, anchor_stride=2, relax_cells=1)


@pytest.mark.parametrize("masked", [False, True])
def test_align_images_matches_jax(rng, nets, monkeypatch, masked):
    jr, ja, resnet, align = nets
    src, tgt, h_true = _translated_pair(rng)
    recorded = _replay_draws(monkeypatch)
    mask = _border_mask() if masked else None
    ref = JRansacFlowAligner(ja, jr, **API).align_images(src, tgt, exclusion_mask=mask)
    out = RansacFlowAligner(align, resnet, "cpu", **API).align_images(
        src, tgt, exclusion_mask=mask)
    assert not recorded  # the one fit replayed
    np.testing.assert_allclose(out["H21"], ref["H21"], atol=1e-6)
    assert _h_error(out["H21"], h_true) < 0.02
    for key in ("flow", "match", "warped_coarse", "warped_fine", "target"):
        assert out[key].shape == np.asarray(ref[key]).shape and isinstance(out[key], np.ndarray)
        np.testing.assert_allclose(out[key], np.asarray(ref[key]), atol=ATOL_MAPS)


def test_align_cli_writes_the_api_result(rng, tmp_path):
    src, tgt, _ = _translated_pair(rng)
    src.save(tmp_path / "a.png")
    tgt.save(tmp_path / "b.png")
    out_dir = tmp_path / "out"
    flags = dict(nbScale=3, coarseIter=256, minSize=IMG, anchorStride=2, relaxCells=1,
                 adaptiveChunk=128)
    cli_align.main(["--img1", str(tmp_path / "a.png"), "--img2", str(tmp_path / "b.png"),
                    "--outdir", str(out_dir), "--device", "cpu",
                    *[a for k, v in flags.items() for a in (f"--{k}", str(v))]])
    for name in ("fine_aligned_source.png", "resized_target.png",
                 "comb_coarse_alignment.png", "comb_fine_alignment.png", "H21.npy"):
        assert (out_dir / name).exists(), name
    api = RansacFlowAligner(
        convert.init_alignment_params(torch.Generator().manual_seed(0), "cpu"),
        convert.init_resnet50_layer3(torch.Generator().manual_seed(0), "cpu"), "cpu",
        nb_scale=3, n_iter=256, min_size=IMG, anchor_stride=2, relax_cells=1,
        adaptive_chunk=128)
    ref = api.align_images(Image.open(tmp_path / "a.png").convert("RGB"),
                           Image.open(tmp_path / "b.png").convert("RGB"))
    np.testing.assert_array_equal(np.load(out_dir / "H21.npy"), ref["H21"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_anchor_resample_kernel_on_card(cuda, rng):
    for (h, w), (fh, fw) in SERVING_RESAMPLES + [((13, 17), (13, 17)), ((9, 11), (9, 7))]:
        fmap = t((3 * rng.randn(1, h, w, 1024)).astype(np.float32)).to(cuda)
        kernels.reset_launch_counts()
        got = anchor_resample_feats(fmap, fh, fw)
        assert kernels.launch_counts()["anchor_resample"] == 1
        torch.testing.assert_close(got, anchor_resample_feats_ref(fmap, fh, fw),
                                   atol=1e-5, rtol=0)
    # the bank form: the 7-scale serving pyramid in one launch
    for stride in (1, 2, 3):
        shapes, nearest, maps = _serving_anchor_maps(rng, stride, channels=1024)
        maps = {i: t(m).to(cuda) for i, m in maps.items()}
        kernels.reset_launch_counts()
        got = anchor_resample_bank(maps, shapes, nearest)
        assert kernels.launch_counts()["anchor_resample"] == 1
        torch.testing.assert_close(got, anchor_resample_bank_ref(maps, shapes, nearest),
                                   atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("relax_cells", [1, 2])
def test_relaxed_mutual_argmax_kernel_on_card(cuda, rng, relax_cells):
    a, b, grid_w = _relax_case(rng, grid_h=30, grid_w=40, n_a=3000, c=32)
    valid_b = t(rng.rand(b.shape[1]) > 0.2).to(cuda)
    raw = (t(a).T @ t(b)).to(cuda)
    score = raw * valid_b.float()[None]
    for args in ((score,), (raw, valid_b)):  # the mask before the kernel or in it
        for ours, ref in zip(mutual_argmax(args[0], relax_cells, grid_w, *args[1:]),
                             mutual_argmax_ref(args[0], relax_cells, grid_w, *args[1:])):
            torch.testing.assert_close(ours, ref, atol=0, rtol=0)
    planted = t(_planted_score()).to(cuda)
    for r in (1, 3):
        torch.testing.assert_close(mutual_argmax(planted, r, 4)[2],
                                   mutual_argmax_ref(planted, r, 4)[2])
