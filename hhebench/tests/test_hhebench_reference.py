"""The benchmark's plain reference against FIPS-197 and against the
port's eager path at a few lanes, on both ciphers."""

import numpy as np
import pytest
import torch

from hhebench.harness import resolve
from hhebench.tests.conftest import bench_with_every_pair
from hhebench.reference import aes as ref_aes
from hhebench.reference import cipher as ref
from hhebench.reference import sampler as ref_sampler

CONFIGS = {"hera-128a": "hera-128a.bulk-vectors",
           "rubato-128l": "rubato-128l.bulk-vectors"}


def _cfg(name):
    return resolve(bench_with_every_pair(), CONFIGS[name])[1]


def test_aes_fips197_vector():
    key = np.arange(16, dtype=np.uint8)
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    rk = torch.as_tensor(ref_aes.key_expand(key[None]).astype(np.int32))
    blk = torch.as_tensor(np.frombuffer(pt, np.uint8).astype(np.int32))[None]
    ct = ref_aes.AES("cpu").encrypt(blk, rk).numpy().astype(np.uint8)
    assert bytes(ct[0]).hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


def test_xof_words_match_the_port():
    from repro_torch.kernels.aes.ref import aes_xof_ref
    from repro_torch.crypto.aes import aes128_key_expand

    rng = np.random.default_rng(1)
    nonces = rng.integers(0, 256, (3, 16), dtype=np.uint8)
    sid = torch.tensor([0, 2, 1, 2])
    ctr = torch.tensor([0, 65535, 17, 4096])
    rk = np.stack([aes128_key_expand(n) for n in nonces])
    got = aes_xof_ref(torch.as_tensor(rk), torch.as_tensor(nonces[:, :12]),
                      sid, ctr, 37)
    ks = ref.Keystream(_cfg("hera-128a"), np.ones(16), "cpu")
    want = ks.aes.xof_words(*ks.tables(nonces), sid, ctr, 37)
    assert torch.equal(got.to(torch.int64) & 0xFFFFFFFF, want)


def test_gauss_table_matches_the_port():
    from repro_torch.crypto.sampler import DGaussTable

    t = DGaussTable.build(1.6)
    tail, keys = ref_sampler.gauss_thresholds(1.6)
    port = [(int(h) << 32 | int(lo)) - (1 << 63) for h, lo in zip(t.hi, t.lo)]
    assert tail == t.tail and keys.tolist() == port


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_keystream_matches_the_port(name):
    from repro_torch.core.cipher import CipherBatch

    cfg = _cfg(name)
    rng = np.random.default_rng(3)
    key = rng.integers(1, cfg["q"], size=cfg["n"])
    nonces = rng.integers(0, 256, (3, 16), dtype=np.uint8)
    cb = CipherBatch(name, key=key, device="cpu")
    for n in nonces:
        cb.add_session(nonce=n)
    sid = np.array([0, 1, 2, 2, 0, 1])
    ctr = np.array([0, 5, 65535, 7, 1000, 12345])
    ks = ref.Keystream(cfg, key, "cpu")
    want = ks.keystream(ks.tables(nonces), torch.as_tensor(sid),
                        torch.as_tensor(ctr), block=4)
    assert torch.equal(cb.keystream(sid, ctr), want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fixed_point_boundary_matches_the_port(name):
    from repro_torch.core.cipher import decrypt_fixed, encrypt_fixed
    from repro_torch.core.params import get_params

    cfg, mod = _cfg(name), get_params(name).mod
    rng = np.random.default_rng(4)
    m = torch.as_tensor(rng.uniform(-8, 8, (5, cfg["l"])).astype(np.float32))
    m[0, :3] = torch.tensor([0.5 / 1024, -1.5 / 1024, 2.5 / 1024])  # ties
    z = torch.as_tensor(rng.integers(0, cfg["q"], (5, cfg["l"])))
    c = torch.as_tensor(rng.integers(0, cfg["q"], (5, cfg["l"])))
    assert torch.equal(encrypt_fixed(mod, m, z, 1024.0),
                       ref.encrypt(m, z, 1024.0, cfg["q"]))
    got = decrypt_fixed(mod, c, z, 1024.0)
    want = ref.decrypt(c, z, 1024.0, cfg["q"])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_bf16_control_moves_the_words():
    cfg = _cfg("hera-128a")
    m = torch.linspace(-8, 8, 64).view(4, 16)
    z = torch.zeros(4, 16, dtype=torch.int64)
    a = ref.encrypt(m, z, 1024.0, cfg["q"])
    b = ref.encrypt(m, z, 1024.0, cfg["q"], torch.bfloat16)
    assert int((a != b).sum()) > 32
