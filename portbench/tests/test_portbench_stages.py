"""The stage readers (`portbench/stages.py`) on synthetic traces, and the
stage metrics left out of a CPU run, which traces no card."""

import pytest

from portbench import stages
from portbench.tests.helpers import REPO, load, run_cell, tiny_tree
from portbench.trace import Trace

STAGE_METRICS = {
    "align480.batch32": {"features_ms_per_pair.align", "matching_ms_per_pair.align",
                         "fine_ms_per_pair.align"},
    "align480.single": {"features_ms.single", "fine_ms.single"},
    "train_stage3.b16": {"forward_ms_per_step.train", "backward_ms_per_step.train",
                         "forward_idle_ms_per_step.train", "backward_idle_ms_per_step.train",
                         "optimizer_idle_ms_per_step.train"},
}


def fake_trace(host, device, window):
    """A `Trace` of the given events: host (start, end, name, correlation
    id), device (start, end, name, linked correlation id), times in us."""
    tr = Trace.__new__(Trace)
    tr.host, tr.device, tr.window_us = sorted(host), sorted(device), window
    return tr


def ctx_of(tr, kind="train", calls=2, units=2):
    return {"trace": tr, "kind": kind, "trace_rec": {"calls": calls, "units": units}}


@pytest.fixture
def two_steps():
    """Two steps, each a span "S" with one launch inside, a launch outside
    any span, an unlinked device op, device gaps that the spans cut, and a
    CUDA call and a profiler marker whose correlation ids collide with
    operations' (as on the card, where CUPTI counts its own ids)."""
    host = [
        (0, 100, "S", 1), (10, 12, "aten::mm", 2),        # step 1
        (150, 250, "S", 3), (200, 201, "_BlurPool", 4),   # step 2
        (120, 121, "aten::add", 5),                        # between the spans
        (295, 296, "cudaLaunchKernel", 2),                 # ids of another count
        (130, 131, "Command Buffer Full", 4),
    ]
    device = [
        (20, 60, "k_in_1", 2),     # launched inside the first span
        (210, 240, "k_in_2", 4),   # inside the second
        (125, 135, "k_out", 5),    # launched between the spans
        (260, 270, "k_free", 0),   # no linked host event
        (280, 290, "k_lost", 99),  # linked to an event the trace lacks
    ]
    return fake_trace(host, device, (0, 300))


def test_device_time_by_the_launch_inside_a_stage(two_steps):
    st = stages.Stages(two_steps)
    assert st.spans("S") == [(0, 100), (150, 250)]
    assert st.device_s("S") == pytest.approx((40 + 30) / 1e6)
    assert st.device_s("absent") == 0
    assert st.unlinked_s() == pytest.approx(20 / 1e6)


def test_cuda_calls_and_markers_launch_nothing():
    assert not stages.can_launch("cudaLaunchKernel")
    assert not stages.can_launch("cuLaunchKernel")
    assert not stages.can_launch("Command Buffer Full")
    assert stages.can_launch("aten::cudnn_convolution") and stages.can_launch("_BlurPool")
    assert stages.can_launch("rf.align.fine")


def test_a_launch_at_the_span_itself_counts():
    """A device op linked to the span's own event (no operation between the
    span and the launch) began at the span's start: inside."""
    tr = fake_trace([(0, 10, "S", 7)], [(2, 5, "hand_kernel", 7)], (0, 10))
    assert stages.Stages(tr).device_s("S") == pytest.approx(3 / 1e6)


def test_idle_is_the_intersection_with_the_spans(two_steps):
    st = stages.Stages(two_steps)
    # busy: 20-60, 125-135, 210-240, 260-270, 280-290 in a 0-300 window
    assert st.idle_intervals() == [(0, 20), (60, 125), (135, 210), (240, 260),
                                   (270, 280), (290, 300)]
    # span 0-100: 0-20 and 60-100; span 150-250: 150-210 and 240-250
    assert st.idle_s("S") == pytest.approx((20 + 40 + 60 + 10) / 1e6)
    assert st.idle_s("absent") == 0


def test_readers_per_call_and_their_silence(two_steps):
    ctx = ctx_of(two_steps)
    assert stages.device_ms(ctx, "train", "S", "calls") == pytest.approx(70 / 1e3 / 2)
    assert stages.idle_ms(ctx, "train", "S", "calls") == pytest.approx(130 / 1e3 / 2)
    assert stages.of(ctx) is stages.of(ctx)
    # another kind of cell, a span the trace lacks (the parent), no device
    assert stages.device_ms(ctx, "align", "S", "calls") is None
    assert stages.device_ms(ctx, "train", "rf.train.forward", "calls") is None
    cpu = ctx_of(fake_trace([(0, 100, "S", 1)], [], (0, 100)))
    assert stages.idle_ms(cpu, "train", "S", "calls") is None


def test_overlap_and_union():
    assert stages.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert stages.overlap_us([(0, 3), (5, 8)], [(2, 6), (7, 10)]) == 3


def test_every_stage_metric_is_in_the_manifest():
    bench = load(REPO / "BENCHMARK.json")
    listed = {m["name"]: m for m in bench["per_layer"]}
    for cell, names in STAGE_METRICS.items():
        for name in names:
            assert listed[name]["workloads"] == [cell]
            assert listed[name]["source"] == "program_span" and listed[name]["unit"] == "ms"


@pytest.mark.parametrize("cell", sorted(STAGE_METRICS))
def test_a_cpu_run_leaves_the_stage_metrics_out(tmp_path, cell):
    root = tiny_tree(tmp_path)
    out, _ = run_cell(root, cell, trace=1)
    assert out["correct"] is True
    assert not STAGE_METRICS[cell] & set(out["metrics"])
