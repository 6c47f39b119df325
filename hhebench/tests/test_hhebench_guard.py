"""What the benchmark may load: no JAX and no JAX package in the process
that prints a result, and a reference that imports nothing of the
program."""

import ast
import json
import os
import subprocess
import sys

import pytest

from hhebench import harness

HERE = harness.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_forbidden_modules_compares_whole_top_level_names():
    mods = {"repro_torch": 1, "repro_torch.core": 1, "reproduce": 1,
            "jax.numpy": 1, "repro.core.farm": 1, "jaxtyping": 1,
            "flax": 1, "numpy": 1}
    assert harness.forbidden_modules(mods) == ["flax", "jax.numpy",
                                               "repro.core.farm"]


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_only_numpy_and_torch(path):
    assert set(_imports(path)) <= {"__future__", "math", "numpy", "torch"}


@pytest.mark.parametrize("path", sorted(p for p in HERE.rglob("*.py")
                                        if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_benchmark_file_imports_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_a_run_loads_no_jax(tmp_path):
    """A whole (tiny, CPU, traced) run in a fresh interpreter."""
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(harness.ROOT / 'src')!r}, "
        f"{str(harness.ROOT)!r}]\n"
        "from hhebench import harness\n"
        "from hhebench.tests.conftest import BULK_TINY\n"
        "a = harness.run_cell('rubato-128l.bulk-vectors', 3, 0.2, True, "
        "'cpu', traffic_overrides=BULK_TINY)\n"
        "print(json.dumps([a['correct'], sorted(sys.modules)]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    ok, mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert ok
    assert "repro_torch" in {m.split(".")[0] for m in mods}
    assert not harness.forbidden_modules(mods)


def test_run_refuses_without_a_card(tmp_path):
    """The command exits non-zero and prints no result where torch sees
    no CUDA device (as on this CPU)."""
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "rubato-128l.bulk-vectors", "--seconds", "1", "--seed", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()
