"""A run is correct only when the timed path is: sound tiny runs on the
CPU pass, and each fault planted underneath the timed path, and the
control (the reference, encoding in bfloat16, in the program's place),
turn ``correct`` false."""

import pytest
import torch

from repro_torch.core import farm as farm_mod
from repro_torch.core.cipher import encode_fixed

CELLS = ["hera-128a.bulk-vectors", "rubato-128l.bulk-vectors"]


def _consume(monkeypatch, alter):
    orig = farm_mod.KeystreamFarm.consume

    def consume(self, constants):
        return alter(self, orig(self, constants).clone())

    monkeypatch.setattr(farm_mod.KeystreamFarm, "consume", consume)


def _unchanged(self, z):
    return torch.zeros_like(z)           # the keystream is never applied


def _half(self, z):
    z[z.shape[0] // 2:] = 0              # half the window left out
    return z


def _one_word(self, z):
    q = self.batch.params.mod.q          # one answer altered at its source
    z[z.shape[0] // 2, 0] = (z[z.shape[0] // 2, 0] + 1) % q
    return z


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny, cell):
    line = tiny(cell, trace=True)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_across_nonce_rotations(tiny, cell, monkeypatch):
    import repro_torch.core.cipher as cipher
    from hhebench import bulk

    for mod in (cipher,):
        monkeypatch.setattr(mod, "SESSION_CTR_LIMIT", 512)
    monkeypatch.setattr(bulk, "CTR_LIMIT", 512)
    line = tiny(cell, seconds=0.6)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("fault", [_unchanged, _half, _one_word],
                         ids=["unchanged", "half", "one_word"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(tiny, cell, fault, monkeypatch):
    _consume(monkeypatch, fault)
    line = tiny(cell)
    assert not line["correct"]
    assert line["checks"]["wrong_words"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_encrypt_without_keystream_is_caught(tiny, cell, monkeypatch):
    monkeypatch.setattr(farm_mod, "encrypt_fixed",
                        lambda mod, m, z, delta: encode_fixed(mod, m, delta))
    assert not tiny(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    line = tiny(cell, control="bf16")
    assert not line["correct"]
    assert line["checks"]["wrong_words"]["value"] > 0
