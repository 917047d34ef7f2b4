"""BENCHMARK.json against the benchmark's contract, and the data-driven
layout: every cell resolves its configuration, mix, driver and metric
readers by name, and a cell is added by adding files only."""

import json
import re

import pytest

from portbench.tests.helpers import BENCH, REPO, dump, load, run_cell, tiny_tree

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return load(REPO / "BENCHMARK.json")


def test_keys_and_limits(bench):
    assert set(bench) == TOP
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(bench["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in bench["command"])
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (REPO / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES


def test_names_and_units(bench):
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry and section != "end_to_end":
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
                    assert "\t" not in entry[key]
    assert len(names) == len(set(names))
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_resolves_its_files(bench):
    from portbench import run

    configs = {c["name"] for c in bench["configs"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        assert w["config"] in configs
        cfg = load(BENCH / "configs" / f"{w['config']}.json")
        assert cfg["limits"] and cfg["precision"], w["config"]
        mix = load(BENCH / "traffic" / f"{w['traffic']}.json")
        assert (BENCH / "drivers" / f"{mix['driver']}.py").is_file()
        ends = [m["name"] for m in run.metrics_of(bench, w, "end_to_end")]
        layers = run.metrics_of(bench, w, "per_layer")
        assert "setup_s" in ends and len(ends) >= 2, w["name"]
        assert layers, w["name"]
        for m in layers:
            assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
            assert m["moves"] in ends, m["name"]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", [])) <= {w["name"] for w in bench["workloads"]}


def test_a_cell_is_added_by_adding_files(tmp_path):
    """A new configuration, mix and per-layer metric as new files, and the
    entries that name them, make a new cell that runs: no file the harness
    already has is edited."""
    root = tiny_tree(tmp_path)
    cfg = load(root / "portbench" / "configs" / "align480.json")
    cfg["name"] = "align64dummy"
    dump(root / "portbench" / "configs" / "align64dummy.json", cfg)
    mix = load(root / "portbench" / "traffic" / "single.json")
    mix["batch_mode"] = "vmap"
    mix["pairs_per_call"] = 2
    dump(root / "portbench" / "traffic" / "pairs2dummy.json", mix)
    (root / "portbench" / "metrics" / "calls_dummy.py").write_text(
        '"""Calls the window completed."""\n\n\ndef read(ctx):\n'
        '    return float(ctx["rec"]["calls"])\n')
    bench = load(root / "BENCHMARK.json")
    bench["configs"].append({"name": "align64dummy", "source": "https://example.org/dummy",
                             "file": "portbench/configs/align64dummy.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "align64dummy.pairs2", "config": "align64dummy",
                               "traffic": "pairs2dummy", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "align_pairs_per_s":
            m["workloads"].append("align64dummy.pairs2")
    bench["per_layer"].append({"name": "calls_dummy", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "serving loop",
                               "moves": "align_pairs_per_s",
                               "workloads": ["align64dummy.pairs2"]})
    dump(root / "BENCHMARK.json", bench)
    out, _ = run_cell(root, "align64dummy.pairs2", trace=0)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"align_pairs_per_s", "setup_s"}
    out, _ = run_cell(root, "align64dummy.pairs2", trace=1)
    assert out["metrics"]["calls_dummy"]["value"] >= 1
    # the device metrics stay silent on the CPU
    assert "mfu.align" not in out["metrics"]


def test_result_line_keys(tmp_path):
    root = tiny_tree(tmp_path)
    out, err = run_cell(root, "train_stage3.b16")
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    # the numbers compared, beside their limits, are the last lines of stderr
    tail = err.strip().splitlines()[-len(out["checks"]):]
    assert [ln.split(":")[0] for ln in tail] == [f"check {k}" for k in out["checks"]]
    json.dumps(out)
