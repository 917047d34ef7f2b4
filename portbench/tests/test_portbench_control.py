"""`correct` must come out false for the control and for each fault a cell
can have. The control: the plain reference with TF32 operands in the
program's place (on the card the control also runs the program itself with
TF32 on: `python3 -m portbench.control`). The faults, each planted in the
program underneath a whole run on the CPU: a fit's answer altered where it
is produced, a fit that returns its first hypothesis (with that
hypothesis's honest count) instead of the best, a flow altered where it is
produced, a training step that
leaves its state unchanged, and a step over half the batch. (The cells run
on one chip: no exchange between chips can be left out.)"""

import copy

import pytest

from portbench import control
from portbench.drivers import align as align_driver
from portbench.drivers import train as train_driver
from portbench.tests.helpers import BENCH, TINY_ALIGN, TINY_MIX, TINY_TRAIN, load, run_cell, \
    tiny_tree


def _session(driver, config, mix, sizes, mix_sizes, seed):
    cfg = copy.deepcopy(load(BENCH / "configs" / f"{config}.json"))
    cfg["settings"].update(sizes)
    m = {**load(BENCH / "traffic" / f"{mix}.json"), **mix_sizes}
    return driver.Session(cfg, m, seed, "cpu")


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_reference_in_tf32_fails_the_alignment_checks(seed):
    s = _session(align_driver, "align480", "batch32", TINY_ALIGN, TINY_MIX["batch32"], seed)
    checks = control.reference_readings(s)
    assert any(c["value"] > c["limit"] for c in checks), checks


def test_reference_in_tf32_fails_the_training_checks():
    s = _session(train_driver, "train_stage3", "b16", TINY_TRAIN, TINY_MIX["b16"], 4)
    checks = control.reference_readings(s)
    assert any(c["value"] > c["limit"] for c in checks), checks


ALTER_FIT = """
from ransacflow_tpu_torch.pipeline import fused
_fit = fused._ransac_batch
def _altered(*a, **k):
    res = _fit(*a, **k)
    shift = res.H21.new_tensor([[0.0, 0.0, 0.1], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    return res._replace(H21=res.H21 + shift * res.H21[..., 2:3, 2:3])
fused._ransac_batch = _altered
"""

ALTER_FLOW = """
from ransacflow_tpu_torch.pipeline import fused
_fine = fused._fine_with_gate_batch
def _altered(*a, **k):
    out = _fine(*a, **k)
    out["flow"] = out["flow"] + 1e-3
    return out
fused._fine_with_gate_batch = _altered
"""

UNCHANGED_STATE = """
from ransacflow_tpu_torch.train import trainer
trainer.train_step = trainer.train_grads
"""

HALF_BATCH = """
from portbench.control import half_batch_fault
half_batch_fault()
"""

FIRST_HYPOTHESIS = """
from portbench.control import first_hypothesis_fault
first_hypothesis_fault()
"""


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("cell,fault,caught_by", [
    ("align480.batch32", ALTER_FIT, "inlier_recount_gap"),
    ("align480.single", ALTER_FIT, "inlier_recount_gap"),
    ("align480.batch32", ALTER_FLOW, "flow_gap"),
    ("align480.batch32", FIRST_HYPOTHESIS, "ransac_best_gap"),
    ("align480.single", FIRST_HYPOTHESIS, "ransac_best_gap"),
    ("train_stage3.b16", UNCHANGED_STATE, "change_norm_gap"),
    ("train_stage3.b16", HALF_BATCH, "grad_norm_gap"),
])
def test_a_fault_makes_the_run_incorrect(tree, cell, fault, caught_by):
    sound, _ = run_cell(tree, cell, seed=21)
    assert sound["correct"] is True, sound["checks"]
    out, _ = run_cell(tree, cell, seed=21, fault=fault)
    assert out["correct"] is False
    assert out["checks"][caught_by]["value"] > out["checks"][caught_by]["limit"]
