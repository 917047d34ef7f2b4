"""The program's spans (`utils/monitor.span`) in a `torch.profiler` trace,
on the CPU: the serving path's request and its four stages, the training
step and its three phases, nested and in order, their names read from the
trace's events (the names the benchmark's readers look for); no
`record_function` without a profiler; outputs bit for bit the same with the
profiler on and off."""

import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ransacflow_tpu_torch.models import convert
from ransacflow_tpu_torch.ops.grid import normalized_grid
from ransacflow_tpu_torch.pipeline import fused
from ransacflow_tpu_torch.train.losses import margin_mask
from ransacflow_tpu_torch.train.trainer import (
    local_index_roll,
    make_optimizer,
    split_trainable,
    train_step,
)
from ransacflow_tpu_torch.utils import monitor

ALIGN_STAGES = ("rf.align.features", "rf.align.matching", "rf.align.fit", "rf.align.fine")
TRAIN_PHASES = ("rf.train.forward", "rf.train.backward", "rf.train.optimizer")
SIZES = (96, 64, 48)
IMG, MARGIN, B = 32, 8, 2
LOSS_KW = dict(mode="flow+match", mu_cycle=1.0, lambda_match=0.01, grad_weight=1.0,
               kernel_size=7)


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def nets():
    gen = torch.Generator().manual_seed(0)
    return convert.init_resnet50_layer3(gen, "cpu"), convert.init_alignment_params(gen, "cpu")


def _pairs(n, seed=0):
    """n pairs: a pyramid of `SIZES` square scales (n, 1, s, s, 3) and a
    64x64 target (n, 1, 64, 64, 3) each."""
    rng = np.random.RandomState(seed)
    pyramids = tuple(torch.from_numpy(rng.rand(n, 1, s, s, 3).astype(np.float32))
                     for s in SIZES)
    return pyramids, torch.from_numpy(rng.rand(n, 1, 64, 64, 3).astype(np.float32))


def _spans(prof):
    """[(start, end, name)] of the program's spans in the trace, by start."""
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events() if e.name().startswith("rf."))


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _inside(child, parent):
    return parent[0] <= child[0] and child[1] <= parent[1]


def _in_order(spans):
    """The spans follow one another with no overlap."""
    return all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def _align(nets, pairs, seed=0):
    resnet, align = nets
    pyramids, targets = pairs
    return fused.fused_align(resnet, align, tuple(p[0] for p in pyramids), targets[0],
                             torch.Generator().manual_seed(seed), n_iter=64)


def _train(nets, n_steps=1):
    """n_steps of `train_step` on copies of the alignment nets; returns the
    steps' metrics and the nets."""
    trained = copy.deepcopy(nets[1])
    opt = make_optimizer(split_trainable(trained, LOSS_KW["mode"])[0], lr=1e-3)
    imgs = torch.from_numpy(np.random.RandomState(1).rand(2 * B, IMG, IMG, 3)
                            .astype(np.float32))
    batch = (imgs, local_index_roll(B, "cpu"), normalized_grid(IMG, IMG, "cpu")[None],
             margin_mask(2 * B, IMG, MARGIN, "cpu"))
    return [train_step(trained, opt, *batch, **LOSS_KW) for _ in range(n_steps)], trained


def test_fused_align_records_the_request_and_its_stages(nets):
    _, spans = _traced(lambda: _align(nets, _pairs(1)))
    assert [s[2] for s in spans] == ["rf.align", *ALIGN_STAGES]
    request, stages = spans[0], spans[1:]
    assert all(_inside(s, request) for s in stages)
    assert _in_order(stages)


@pytest.mark.parametrize("batch_mode,per_stage", [("vmap", 1), ("scan", 2)])
def test_fused_align_batch_records_each_stage_per_chunk(nets, batch_mode, per_stage):
    resnet, align = nets
    pyramids, targets = _pairs(2)
    _, spans = _traced(lambda: fused.fused_align_batch(
        resnet, align, pyramids, targets, torch.Generator().manual_seed(0), n_iter=64,
        batch_mode=batch_mode))
    names = [s[2] for s in spans]
    assert names == ["rf.align"] + list(ALIGN_STAGES) * per_stage
    assert all(_inside(s, spans[0]) for s in spans[1:])
    assert _in_order(spans[1:])


def test_train_step_records_the_step_and_its_phases(nets):
    _, spans = _traced(lambda: _train(nets))
    names = [s[2] for s in spans]
    assert names == ["rf.train.step", *TRAIN_PHASES]
    assert all(_inside(s, spans[0]) for s in spans[1:])
    assert _in_order(spans[1:])


def test_stage_timer_stage_is_a_span():
    timer = monitor.StageTimer()

    def stage():
        with timer.time("rf.user_stage"):
            torch.ones(2).add_(1)

    _, spans = _traced(stage)
    assert [s[2] for s in spans] == ["rf.user_stage"]
    assert timer.counts == {"rf.user_stage": 1}


def test_no_record_function_without_a_profiler(nets, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with monitor.span("rf.anything") as inside:
        assert inside is None
    assert monitor.span("a") is monitor.span("b")
    _align(nets, _pairs(1))
    resnet, align = nets
    fused.fused_align_batch(resnet, align, *_pairs(2), torch.Generator().manual_seed(0),
                            n_iter=64, batch_mode="scan")
    _train(nets)
    timer = monitor.StageTimer()
    with timer.time("stage"):
        pass
    assert timer.counts == {"stage": 1}


@pytest.mark.parametrize("path", ["align", "align_batch", "train"])
def test_outputs_bit_for_bit_with_the_profiler_on_and_off(nets, path):
    def run():
        if path == "align":
            return _align(nets, _pairs(1))
        if path == "align_batch":
            resnet, align = nets
            return fused.fused_align_batch(resnet, align, *_pairs(2),
                                           torch.Generator().manual_seed(0), n_iter=64,
                                           batch_mode="vmap")
        metrics, trained = _train(nets, n_steps=2)
        return {**{f"{k}{i}": v for i, m in enumerate(metrics) for k, v in m.items()},
                **{f"{n}.{k}": v for n, net in trained.items()
                   for k, v in net.state_dict().items()}}

    off = run()
    on, spans = _traced(run)
    assert spans
    assert off.keys() == on.keys()
    for key in off:
        assert torch.equal(off[key], on[key]), key
