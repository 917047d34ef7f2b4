"""The plain reference against the program at tiny sizes on the CPU (where
the program runs its kernels' plain versions): layer by layer with the same
weights, then whole runs of each configuration judged correct."""

import json

import torch

from portbench import weights
from portbench.drivers import align as align_driver
from portbench.reference import align as ref
from portbench.reference import nets
from portbench.tests.helpers import BENCH, REPO, run_cell, tiny_tree


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_trunk_matches_the_program():
    from ransacflow_tpu_torch.models.resnet50 import ResNet50Layer3, imagenet_preprocess, \
        resnet50_layer3

    p = weights.seeded(nets.resnet50_layer3_spec(), _gen(1))
    net = weights.load_into(ResNet50Layer3(), p)
    x = torch.rand(2, 48, 64, 3, generator=_gen(2))
    with torch.no_grad():
        want = resnet50_layer3(net, imagenet_preprocess(x))
        got = nets.resnet50_layer3(p, nets.imagenet_preprocess(x)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 3, 4, 1024)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_fine_networks_match_the_program():
    from ransacflow_tpu_torch.kernels.correlation import correlation_pair
    from ransacflow_tpu_torch.kernels.heads import head_epilogues
    from ransacflow_tpu_torch.models.feature_extractor import FeatureExtractor, \
        feature_extractor
    from ransacflow_tpu_torch.models.heads import Head, head_logits

    fine = weights.from_npz(REPO / "portbench" / "assets" / "accept_weights.npz", "cpu")
    fe = weights.load_into(FeatureExtractor(), fine["netFeatCoarse"])
    flow = weights.load_into(Head(7, 49), fine["netFlowCoarse"])
    match = weights.load_into(Head(7, 1), fine["netMatch"])
    a, b = torch.rand(2, 1, 64, 96, 3, generator=_gen(3))
    with torch.no_grad():
        fa = nets.l2_normalize(feature_extractor(fe, a), dim=-1)
        fb = nets.l2_normalize(feature_extractor(fe, b), dim=-1)
        ra = ref.fine_features(fine["netFeatCoarse"], a, "exact")
        rb = ref.fine_features(fine["netFeatCoarse"], b, "exact")
        assert (ra.permute(0, 2, 3, 1) - fa).abs().max() <= 1e-5
        c12, c21 = correlation_pair(fa, fb, 7)
        r12, r21 = nets.correlation(ra, rb, 7), nets.correlation(rb, ra, 7)
        assert (r12.permute(0, 2, 3, 1) - c12).abs().max() <= 1e-5
        assert (r21.permute(0, 2, 3, 1) - c21).abs().max() <= 1e-5
        f8, m12, _, _ = head_epilogues(head_logits(flow, c12), head_logits(match, c12),
                                       head_logits(match, c21), 7)
        rf = nets.flow_epilogue(nets.head(fine["netFlowCoarse"], r12), 7)
        rm = torch.sigmoid(nets.head(fine["netMatch"], r12)).permute(0, 2, 3, 1)
        assert (rf - f8).abs().max() <= 1e-5 and (rm - m12).abs().max() <= 1e-5


def test_pyramid_matches_the_program():
    from ransacflow_tpu_torch.kernels.pyramid import device_pyramid

    shapes = align_driver.pyramid_shapes(64, (64, 96), 5, 2.0)
    x = torch.rand(2, *shapes[0], 3, generator=_gen(4))
    for got, want in zip(ref.pyramid(x, shapes), device_pyramid(x, shapes)):
        assert got.shape == want.shape and (got - want).abs().max() <= 1e-5


def test_whole_runs_are_correct(tmp_path):
    root = tiny_tree(tmp_path)
    for cell in ("align480.batch32", "align480.single", "train_stage3.b16"):
        out, _ = run_cell(root, cell, seed=2 ** 31 + 11)
        assert out["correct"] is True, (cell, out["checks"])
        assert out["attempted"] >= 1 and out["failed"] == 0


def test_configs_state_their_sources():
    for name in ("align480", "train_stage3"):
        cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        assert cfg["precision"] == "float32, TF32 off"
        assert set(cfg["settings"]) >= set(cfg["origin"])
        assert cfg["reduced"] == [] and cfg["limits"]
