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
from repro_torch.configs.base import get_config  # noqa: E402
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
from repro_torch.crypto.aes import aes_ctr_keystream  # noqa: E402
from repro_torch.crypto.xof import threefry_xof_words  # noqa: E402
from repro_torch.data.encrypted import FarmEncryptedSource  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.serve import EncryptedChannel  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import init_cache, init_params  # noqa: E402
from repro_torch.serve.serve_loop import (  # noqa: E402
    make_decode_step,
    make_prefill_step,
)
from repro_torch.serve.server import ServeClient  # noqa: E402
from repro_torch.serve.tenants import TenantRegistry  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.train_loop import make_train_step  # noqa: E402

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
            "repro_torch.analysis.__main__", "repro_torch.core.hera",
            "repro_torch.core.rubato", "repro_torch.core.pasta",
            "repro_torch.configs", "repro_torch.configs.base",
            "repro_torch.configs.granite_3_8b", "repro_torch.models",
            "repro_torch.models.layers", "repro_torch.models.attention",
            "repro_torch.models.mamba2", "repro_torch.models.moe",
            "repro_torch.models.model", "repro_torch.models.convert",
            "repro_torch.serve.serve_loop", "repro_torch.launch",
            "repro_torch.launch.serve", "repro_torch.data.pipeline",
            "repro_torch.launch.elastic", "repro_torch.launch.train",
            "repro_torch.train", "repro_torch.train.optimizer",
            "repro_torch.train.train_loop", "repro_torch.train.checkpoint",
            "repro_torch.train.tree"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'repro',\n"
            "       'ml_dtypes') or m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    src = str(PKG.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=src),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _assert_no_jax_or_reference(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
                (path, n)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(PKG)) for p in PKG.rglob("*.py")))
def test_no_file_imports_jax_or_the_reference(path):
    _assert_no_jax_or_reference(PKG / path)


@pytest.mark.parametrize("name", ["torch_quickstart.py",
                                  "torch_keystream_farm.py",
                                  "torch_encrypted_training.py"])
def test_no_port_example_imports_jax_or_the_reference(name):
    _assert_no_jax_or_reference(PKG.parents[1] / "examples" / name)


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
    lambda: aes_ctr_keystream(np.zeros((11, 16), np.uint8),
                              np.zeros(12, np.uint8), 0, 4),
    lambda: make_engine("sharded", get_params("hera-80"), np.ones(16),
                        devices=["cuda"]),
    lambda: init_params(get_config("granite-3-8b", smoke=True)),
    lambda: init_cache(get_config("granite-3-8b", smoke=True), 1, 4),
    lambda: params_from_reference(get_config("granite-3-8b", smoke=True),
                                  {}),
    lambda: make_prefill_step(get_config("granite-3-8b", smoke=True), 8),
    lambda: make_decode_step(get_config("granite-3-8b", smoke=True)),
    lambda: EncryptedChannel("hera-80", 1),
    lambda: serve_main(["--arch", "granite-3-8b", "--smoke"]),
    lambda: make_train_step(get_config("granite-3-8b", smoke=True),
                            OptConfig()),
    lambda: train_main(["--arch", "granite-3-8b", "--smoke", "--steps",
                        "1"]),
], ids=["CipherBatch", "make_cipher", "make_producer", "make_engine",
        "threefry_producer", "threefry_words", "TenantRegistry",
        "ServeClient", "default", "cuda", "autotune", "measure_plan",
        "load_plan", "FarmEncryptedSource", "measured_depth",
        "MachineModel", "aes_ctr_keystream", "sharded_engine",
        "init_params", "init_cache", "params_from_reference",
        "make_prefill_step", "make_decode_step", "EncryptedChannel",
        "serve_main", "make_train_step", "train_main"])
def test_entry_points_raise_without_cuda(no_cuda, make):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make()


def test_training_example_raises_without_a_card():
    """No card visible: the example stops and names --device cpu; with it,
    it runs (tests/test_torch_train.py)."""
    out = subprocess.run(
        [sys.executable, str(PKG.parents[1] / "examples" /
                             "torch_encrypted_training.py"), "--steps", "1"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert 'device="cpu"' in out.stderr and "step" not in out.stdout


def test_explicit_cpu_runs_and_auto_follows_the_device(no_cuda):
    cb = CipherBatch("hera-80", device="cpu")
    assert cb.device.type == "cpu"
    assert cb.make_engine("auto").name == "ref"
    assert resolve_engine("auto", "cpu") == "ref"
    assert resolve_engine("auto", "cuda") == "cuda"
    with pytest.raises(RuntimeError, match="unavailable"):
        cb.make_engine("cuda")
