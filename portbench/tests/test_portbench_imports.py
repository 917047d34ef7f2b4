"""What the benchmark loads: never JAX, jaxlib, flax or the JAX package
(compared by whole top-level names: the port's name begins with the JAX
package's), and a reference that imports nothing of the program."""

import ast
import os
import subprocess
import sys

from portbench.tests.helpers import BENCH, REPO, run_cell, tiny_tree

FORBIDDEN = {"jax", "jaxlib", "flax", "ransacflow_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"math", "numpy", "torch", "portbench"}, (path, tops)
        assert not any(n.startswith("portbench.") and not n.startswith("portbench.reference")
                       for n in _imports(path)), path
    code = ("import sys\nimport portbench.reference.align, portbench.reference.train\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip()))
    assert "ransacflow_tpu_torch" not in loaded and not loaded & FORBIDDEN


def test_a_run_loads_no_jax(tmp_path):
    """A whole run of each configuration's driver on the CPU, then the
    process's modules by whole top-level name."""
    root = tiny_tree(tmp_path)
    fault = ("import atexit\n"
             "atexit.register(lambda: print('MODULES', sorted({m.split('.')[0] "
             "for m in sys.modules}), file=sys.stderr))")
    for cell in ("align480.single", "train_stage3.b16"):
        _, err = run_cell(root, cell, fault=fault)
        line = [ln for ln in err.splitlines() if ln.startswith("MODULES")][-1]
        loaded = set(eval(line.split(" ", 1)[1]))
        assert "ransacflow_tpu_torch" in loaded
        assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_harness_refuses_without_a_card_or_a_program(tmp_path):
    """No CUDA card: exit 2 and no result line. A directory with only
    BENCHMARK.json and portbench/: exit 2."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    args = [sys.executable, "-m", "portbench.run", "--workload", "align480.batch32", "--seed",
            "2147483999", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(args, cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    root = tiny_tree(tmp_path)
    out = subprocess.run(args, cwd=root, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(root)})
    assert out.returncode != 0 and out.stdout.strip() == ""
