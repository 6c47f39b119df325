"""The port's process-group plumbing (``repro_torch.launch.mesh``) and the
launchers under ``torchrun``.

* :func:`rank_device`: a card named by its index is kept; ``None`` or
  ``"cuda"`` is the card of torchrun's ``LOCAL_RANK`` (modulo the cards
  present).  The card is faked by monkeypatching ``torch.cuda``.
* Both launchers' ``run`` hand the process group the device the caller
  asked for, so a rank without ``--device`` lands on ``cuda:LOCAL_RANK``
  and not on the card ``resolve_device`` would pick first.
* A launched world of several ranks without ``--mesh`` or
  ``--production-mesh`` raises, naming both.
* ``torchrun --standalone --nproc-per-node 2`` (a free port on
  localhost) runs ``launch.train`` and ``launch.serve`` with ``--mesh
  1,2 --device cpu --encrypted`` on smoke granite-3-8b: serving checks
  its decrypted prompts and round trips on rank 0 itself; each training
  loss that rank 0 prints (4 decimals) is within 2e-3 of the one-device
  run's.  The smoke config computes in bf16 and tp 2 sums each split
  product in another order: the two runs read 1e-4 apart here, and one
  bf16 ulp of a logit near 1 is 2**-7 (7.8e-3).  The float32 numbers of
  the sharded model are held to the reference in
  ``tests/test_torch_sharded_model.py``.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.launch import serve as LS  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH = "granite-3-8b"
LOSS_TOL = 2e-3
TRAIN_ARGS = ["--arch", ARCH, "--smoke", "--steps", "2", "--log-every",
              "1", "--encrypted", "--device", "cpu"]
SERVE_ARGS = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len",
              "16", "--gen", "4", "--encrypted", "--device", "cpu"]


@pytest.fixture
def four_cards(monkeypatch):
    """``torch.cuda`` as on a host with four cards (nothing launches)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


@pytest.mark.parametrize("asked,local_rank,want", [
    (None, "2", "cuda:2"),
    ("cuda", "3", "cuda:3"),
    (torch.device("cuda"), "1", "cuda:1"),
    (None, "5", "cuda:1"),           # modulo the cards present
    (None, None, "cuda:0"),          # no torchrun: the first card
    ("cuda:1", "3", "cuda:1"),       # an index asked for is kept
    ("cpu", "2", "cpu"),
])
def test_rank_device_maps_local_rank_to_its_card(four_cards, monkeypatch,
                                                 asked, local_rank, want):
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    assert MESH.rank_device(asked) == torch.device(want)


class _Started(Exception):
    pass


@pytest.mark.parametrize("launcher", ["train", "serve"])
def test_launcher_puts_each_rank_on_its_local_card(four_cards, monkeypatch,
                                                   launcher):
    mod, argv = {"train": (LT, TRAIN_ARGS), "serve": (LS, SERVE_ARGS)}[
        launcher]
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")

    def start(device=None, **kw):
        raise _Started(MESH.rank_device(device))

    monkeypatch.setattr(mod, "init_distributed", start)
    args = mod.parse_args(argv[:-2])             # no --device: the card
    with pytest.raises(_Started) as got:
        mod.run(get_config(ARCH, smoke=True), args, mesh=object())
    assert got.value.args[0] == torch.device("cuda", 3)


@pytest.mark.parametrize("launcher", ["train", "serve"])
def test_world_of_several_ranks_needs_a_mesh_flag(monkeypatch, launcher):
    mod, argv = {"train": (LT, TRAIN_ARGS), "serve": (LS, SERVE_ARGS)}[
        launcher]
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="world of 2 ranks needs --mesh"):
        mod.run(get_config(ARCH, smoke=True), mod.parse_args(argv))


def _torchrun(module: str, argv, tmp_path) -> str:
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "XLA_FLAGS"):
        env.pop(k, None)
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", module, *argv, "--mesh", "1,2"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "torch.distributed: world 2, backend gloo" in r.stdout
    assert "sharded: mesh {'data': 1, 'tp_a': 2" in r.stdout
    return r.stdout


def test_torchrun_train_matches_one_device(tmp_path):
    out = _torchrun("repro_torch.launch.train", TRAIN_ARGS, tmp_path)
    got = [float(v) for v in re.findall(r"loss (\S+)", out)]
    one = LT.run(get_config(ARCH, smoke=True), LT.parse_args(TRAIN_ARGS))
    want = [h["loss"] for h in one["history"]]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_TOL, (got, want)


def test_torchrun_serve_round_trips(tmp_path):
    out = _torchrun("repro_torch.launch.serve", SERVE_ARGS, tmp_path)
    assert "round-trip verified client-side (2 lanes)" in out
