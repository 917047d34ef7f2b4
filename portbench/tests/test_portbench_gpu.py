"""On the card: one short run of each cell through the command BENCHMARK.json
names, its result line read as the contract has it.

    python3 -m pytest -m gpu portbench/tests
"""

import json
import os
import subprocess
import sys

import pytest

from portbench.tests.helpers import REPO, load


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_each_cell_runs_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = load(REPO / "BENCHMARK.json")
    for cell in bench["workloads"]:
        cmd = bench["command"] + ["--workload", cell["name"], "--seed", "2147483777",
                                  "--seconds", "2", "--trace", str(trace)]
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=900,
                              env={**os.environ, "PYTHONPATH": str(REPO)})
        assert proc.returncode == 0, proc.stderr[-3000:]
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        assert out["correct"] is True, out["checks"]
        assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
        assert out["device"]["kind"] == torch.cuda.get_device_name(0)
        assert "setup_s" in out["metrics"] or trace
        if trace:
            assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"] * 1.001
            for name, m in out["metrics"].items():
                if name.startswith(("mfu", "hand_kernels_roofline")):
                    assert 0 < m["value"] <= 105, (name, m)
    assert sys.modules.get("jax") is None
