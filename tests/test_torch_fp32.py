"""The port's float32 policy, on the CPU: float32 compute means float32 on
the card, so the entry points turn TF32 off for cuDNN's convolutions and
for CUDA matrix products (PyTorch's default leaves cuDNN's on), as the
reference's float32 default does (`ransacflow_tpu/cli/common.py:90-99`).

The command-line entry points set the flags for their process once their
arguments are handled; the tests replace the heavy work after that point
and read the flags there. `RansacFlowAligner` is a library class: inside
its call the flags are off, and the caller's are restored after it.
"""

import argparse

import numpy as np
import pytest
import torch
from PIL import Image

from ransacflow_tpu_torch.cli import align as cli_align
from ransacflow_tpu_torch.cli import common as cli_common
from ransacflow_tpu_torch.cli import eval_corr, eval_hpatches, eval_kitti, eval_yfcc
from ransacflow_tpu_torch.cli import generate_pairs as cli_generate_pairs
from ransacflow_tpu_torch.cli import train as cli_train
from ransacflow_tpu_torch.models import convert, segnet
from ransacflow_tpu_torch.pipeline.api import RansacFlowAligner


def tf32_flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def set_tf32_flags(cudnn, matmul):
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


@pytest.fixture
def tf32_on():
    """Both flags on for the test, the process's own restored after it."""
    saved = tf32_flags()
    set_tf32_flags(True, True)
    yield
    set_tf32_flags(*saved)


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_align_cli_turns_tf32_off(tf32_on, monkeypatch, tmp_path):
    seen = []

    class Aligner:  # records the flags the aligner would be built under
        def __init__(self, *args, **kwargs):
            seen.append(tf32_flags())

        def align_images(self, img1, img2):
            return {"H21": None}

    monkeypatch.setattr(cli_align, "RansacFlowAligner", Aligner)
    monkeypatch.setattr(cli_align, "load_align_params", lambda *args: None)
    monkeypatch.setattr(cli_align, "load_coarse_net", lambda *args: None)
    for name in ("a.png", "b.png"):
        Image.new("RGB", (8, 8)).save(tmp_path / name)
    cli_align.main(["--img1", str(tmp_path / "a.png"), "--img2", str(tmp_path / "b.png"),
                    "--outdir", str(tmp_path / "out"), "--device", "cpu"])
    assert seen == [(False, False)]


def test_train_cli_turns_tf32_off(tf32_on, monkeypatch, tmp_path):
    seen = []
    monkeypatch.setattr(cli_train, "init_alignment_params", lambda *args: None)
    monkeypatch.setattr(cli_train, "fit", lambda *args, **kwargs: seen.append(tf32_flags()))
    cli_train.main(["--trainImgDir", str(tmp_path), "--outDir", str(tmp_path / "out"),
                    "--stage", "3", "--computeDtype", "float32", "--device", "cpu", "NoVal"])
    assert seen == [(False, False)]


EVAL_CLIS = {  # module, its predict and results paths, what its results pass returns
    "hpatches": (eval_hpatches, ["--csv-path", "c", "--image-data-path", "i"],
                 ["--csv-path", "c", "--image-data-path", "i"], ({2: 0.0}, {})),
    "kitti": (eval_kitti, ["--testImg", "i"], ["--gtPath", "g"], (0.0, [])),
    "corr": (eval_corr, ["--testCSV", "c", "--testDir", "i"],
             ["--testCSV", "c", "--testDir", "i"], {0.0: (np.zeros(8), 0)}),
    "yfcc": (eval_yfcc, ["--testImg", "i", "--testPair", "p", "--testScene", "reichstag"],
             ["--gtPath", "g", "--testPair", "p", "--scene", "2", "--outRes", "OUT"],
             ([0.0], {"acc5": 1.0})),
}


@pytest.mark.parametrize("cmd", ["predict", "results"])
@pytest.mark.parametrize("cli", list(EVAL_CLIS))
def test_eval_clis_turn_tf32_off(tf32_on, monkeypatch, tmp_path, cli, cmd):
    """Each eval CLI, both subcommands: the flags are off where the
    harness runs."""
    module, predict_paths, results_paths, result = EVAL_CLIS[cli]
    seen = []
    record = lambda *args, **kwargs: seen.append(tf32_flags()) or result  # noqa: E731
    monkeypatch.setattr(module, f"predict_{cli}", record)
    monkeypatch.setattr(module, f"evaluate_{cli}", record)
    monkeypatch.setattr(module, "load_align_params", lambda *args: None)
    monkeypatch.setattr(module, "load_coarse_net", lambda *args: None)
    if cmd == "predict":
        argv = [*predict_paths, "--outDir", str(tmp_path)]
    else:
        argv = [*results_paths, "--predDir", str(tmp_path)]
    argv = [str(tmp_path / "out.json") if a == "OUT" else a for a in argv]
    module.main([cmd, *argv, "--device", "cpu"])
    assert seen == [(False, False)]


def test_generate_pairs_cli_turns_tf32_off(tf32_on, monkeypatch, tmp_path):
    seen = []
    (tmp_path / "pairs.csv").write_text("imgA,imgB\na.png,b.png\n")
    for name in ("a.png", "b.png"):
        Image.new("RGB", (8, 8)).save(tmp_path / name)
    monkeypatch.setattr(cli_generate_pairs, "load_coarse_net", lambda *args: None)
    monkeypatch.setattr(cli_generate_pairs, "align_pair",
                        lambda *args: seen.append(tf32_flags()) or (0, None, None, None))
    cli_generate_pairs.main(["--pairCSV", str(tmp_path / "pairs.csv"), "--imgDir",
                             str(tmp_path), "--outDir", str(tmp_path / "out"), "--device",
                             "cpu"])
    assert seen == [(False, False)]


@pytest.mark.parametrize("seg_net", [True, False])
def test_sky_hook_turns_tf32_off(tf32_on, monkeypatch, seg_net):
    """With --segNet the sky network runs with TF32 off; without it the
    flags are left alone."""
    monkeypatch.setattr(cli_common, "load_segnet", lambda *args: (None, None))
    monkeypatch.setattr(segnet, "SkySegmenter", lambda *args, **kwargs: None)
    args = argparse.Namespace(segNet=seg_net, segEncoderPth=None, segDecoderPth=None)
    assert (cli_common.build_sky_fn(args, "cpu") is None) == (not seg_net)
    assert tf32_flags() == ((False, False) if seg_net else (True, True))


@pytest.mark.parametrize("caller", [(True, True), (True, False), (False, True)])
def test_aligner_calls_run_without_tf32_and_restore_the_callers_flags(
        tf32_on, monkeypatch, rng, caller):
    """Every convolution of an `align_images` call (the coarse trunk and the
    fine stage) sees both flags off; the caller's flags, PyTorch's defaults
    (cuDNN on, matmul off) among them, are restored after the call. The
    frozen networks call `F.conv2d` with their folded weights (on the card
    the fine networks' go to kernel 15 instead), so every convolution is
    recorded there."""
    seen = []
    conv2d = torch.nn.functional.conv2d

    def recording(*args, **kwargs):
        seen.append(tf32_flags())
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", recording)
    aligner = RansacFlowAligner(
        convert.init_alignment_params(torch.Generator().manual_seed(0), "cpu"),
        convert.init_resnet50_layer3(torch.Generator().manual_seed(0), "cpu"), "cpu",
        nb_scale=2, n_iter=64, min_size=64)
    base = np.kron((rng.rand(16, 16, 3) > 0.5), np.ones((4, 4, 1)))
    img = Image.fromarray((base * 255).astype(np.uint8))
    set_tf32_flags(*caller)
    out = aligner.align_images(img, img)
    assert tf32_flags() == caller
    assert out["H21"] is not None  # the fine stage ran too
    assert len(seen) > 0 and set(seen) == {(False, False)}
