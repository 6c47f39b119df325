"""Guards on the PyTorch port: it never imports JAX or the reference
package, and its entry points never fall back to the CPU on their own."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro_torch  # noqa: E402
from repro_torch.analysis.cost import MachineModel  # noqa: E402
from repro_torch.core.cipher import CipherBatch, make_cipher  # noqa: E402
from repro_torch.core.engine import make_engine, resolve_engine  # noqa: E402
from repro_torch.core.params import get_params  # noqa: E402
from repro_torch.core.producer import make_producer  # noqa: E402
from repro_torch.core.transcipher import measured_depth  # noqa: E402
from repro_torch.core.tuner import (  # noqa: E402
    StreamPlan,
    autotune,
    load_plan,
    measure_plan,
)
from repro_torch.crypto.xof import threefry_xof_words  # noqa: E402
from repro_torch.data.encrypted import FarmEncryptedSource  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.serve.server import ServeClient  # noqa: E402
from repro_torch.serve.tenants import TenantRegistry  # noqa: E402

PKG = Path(repro_torch.__file__).resolve().parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG)], prefix="repro_torch."))


def test_every_module_imports_without_jax():
    mods = _modules()
    assert {"repro_torch.serve.hhe_loop", "repro_torch.serve.tenants",
            "repro_torch.serve.server", "repro_torch.core.tuner",
            "repro_torch.core.transcipher", "repro_torch.data.encrypted",
            "repro_torch.analysis", "repro_torch.analysis.bounds",
            "repro_torch.analysis.lint", "repro_torch.analysis.cost",
            "repro_torch.analysis.__main__"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro'\n"
            "       or m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    src = str(PKG.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=src),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(PKG)) for p in PKG.rglob("*.py")))
def test_no_file_imports_jax_or_the_reference(path):
    tree = ast.parse((PKG / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, n)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("make", [
    lambda: CipherBatch("hera-80"),
    lambda: make_cipher("rubato-128s"),
    lambda: make_producer(None, get_params("pasta-128s")),
    lambda: make_engine("auto", get_params("hera-80"), np.ones(16)),
    lambda: make_producer("threefry", get_params("hera-80")),
    lambda: threefry_xof_words(np.zeros(16, np.uint8), [0], 4),
    lambda: TenantRegistry("hera-80"),
    lambda: ServeClient("127.0.0.1", 1, "t"),
    lambda: resolve_device(None),
    lambda: resolve_device("cuda"),
    lambda: autotune("hera-80", 8, cache_path=os.devnull),
    lambda: measure_plan("hera-80", StreamPlan("aes", "ref", "normal", 8, 2),
                         8),
    lambda: load_plan("hera-80", 8, cache_path=os.devnull),
    lambda: FarmEncryptedSource(None, CipherBatch("hera-80")),
    lambda: measured_depth(get_params("hera-80")),
    lambda: MachineModel.for_backend(),
], ids=["CipherBatch", "make_cipher", "make_producer", "make_engine",
        "threefry_producer", "threefry_words", "TenantRegistry",
        "ServeClient", "default", "cuda", "autotune", "measure_plan",
        "load_plan", "FarmEncryptedSource", "measured_depth",
        "MachineModel"])
def test_entry_points_raise_without_cuda(no_cuda, make):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make()


def test_explicit_cpu_runs_and_auto_follows_the_device(no_cuda):
    cb = CipherBatch("hera-80", device="cpu")
    assert cb.device.type == "cpu"
    assert cb.make_engine("auto").name == "ref"
    assert resolve_engine("auto", "cpu") == "ref"
    assert resolve_engine("auto", "cuda") == "cuda"
    with pytest.raises(RuntimeError, match="unavailable"):
        cb.make_engine("cuda")
