"""The port's transciphering (`repro_torch.core.transcipher`) against the
JAX package's: the depth-tracked decryption circuit's keystream and
multiplicative depth on every preset, exactly, and the recovered slots
within the reference test's tolerances (tests/test_ciphers.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core.cipher import make_cipher as ref_make_cipher  # noqa: E402
from repro.core.transcipher import (  # noqa: E402
    evaluate_decryption_circuit as ref_circuit,
    transcipher as ref_transcipher,
)

from repro_torch.core.cipher import CipherBatch, make_cipher  # noqa: E402
from repro_torch.core.params import REGISTRY, get_params  # noqa: E402
from repro_torch.core.transcipher import (  # noqa: E402
    CircuitMod,
    DepthTracked,
    evaluate_decryption_circuit,
    measured_depth,
    transcipher,
)

PRESETS = sorted(REGISTRY)
DEPTHS = {"hera-128a": 10, "rubato-128l": 2, "pasta-128l": 4}


@pytest.mark.parametrize("name", PRESETS)
def test_circuit_matches_reference(name):
    ctrs = np.arange(3)
    z, depth = evaluate_decryption_circuit(
        make_cipher(name, seed=5, device="cpu"), ctrs)
    rz, rdepth = ref_circuit(ref_make_cipher(name, seed=5),
                             jnp.asarray(ctrs, jnp.uint32))
    assert depth == rdepth
    assert z.dtype == torch.int64 and z.shape == (3, get_params(name).l)
    np.testing.assert_array_equal(z.numpy(), np.asarray(rz).astype(np.int64))


@pytest.mark.parametrize("name", PRESETS)
def test_measured_depth_follows_the_paper_law(name):
    p = get_params(name)
    law = {"hera": 2 * p.rounds, "rubato": p.rounds, "pasta": p.rounds + 1}
    assert measured_depth(p, device="cpu") == law[p.kind]
    assert DEPTHS.get(name, law[p.kind]) == law[p.kind]


@pytest.mark.parametrize("name,seed,tol", [
    # server-side recovery is exact up to the cipher's own AGN noise
    ("rubato-128l", 7, 10 * 1.6 / 1024 + 1 / 2048),
    # no AGN stage: exact to the fixed-point grid
    ("pasta-128l", 7, 1 / 2048),
    ("hera-128a", 9, 1 / 2048),
])
def test_transcipher_recovers_slots_like_the_reference(name, seed, tol):
    ci = make_cipher(name, seed=seed, device="cpu")
    ref = ref_make_cipher(name, seed=seed)
    ctrs = np.arange(3)
    m = np.random.default_rng(seed + 1).uniform(
        -4, 4, (3, ci.params.l)).astype(np.float32)
    ct = ci.encrypt(m, ctrs)
    rct = ref.encrypt(m, jnp.asarray(ctrs, jnp.uint32))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(rct).astype(np.int64))
    slots, depth = transcipher(ci, ct, ctrs)
    rslots, rdepth = ref_transcipher(ref, rct, jnp.asarray(ctrs, jnp.uint32))
    assert depth == rdepth == DEPTHS[name]
    assert slots.dtype == torch.float32
    np.testing.assert_array_equal(slots.numpy(), np.asarray(rslots))
    assert np.abs(slots.numpy() - m).max() < tol
    # the ciphertext may arrive as uint32 words off the wire
    again, _ = transcipher(ci, ct.numpy().astype(np.uint32), ctrs)
    np.testing.assert_array_equal(again.numpy(), slots.numpy())


def test_rubato_circuit_differs_from_the_engine_by_the_noise_plane():
    ci = make_cipher("rubato-128l", seed=3, device="cpu")
    ctrs = np.arange(4)
    z, _ = evaluate_decryption_circuit(ci, ctrs)
    k = ci.round_constant_stream(ctrs)
    mod = ci.params.mod
    np.testing.assert_array_equal(
        mod.add(z, mod.from_signed(k["noise"])).numpy(),
        ci.keystream(ctrs).numpy())
    assert not torch.equal(z, ci.keystream(ctrs))


def test_transcipher_rejects_a_wrong_width():
    ci = make_cipher("pasta-128s", seed=1, device="cpu")
    with pytest.raises(ValueError, match="last dim"):
        transcipher(ci, np.zeros((2, ci.params.n), np.int64), np.arange(2))


def test_depth_tracking_algebra():
    cm = CircuitMod(get_params("hera-80"))
    a = DepthTracked(torch.tensor([3]), 2)
    b = DepthTracked(torch.tensor([5]), 4)
    assert cm.add(a, b).depth == 4 and cm.mul_ct(a, b).depth == 5
    assert cm.mul_pt(a, torch.tensor([7])).depth == 2
    assert int(cm.mul_ct(a, b).value) == 15


def test_cipher_encode_decode_and_batch_len_match_reference():
    ci = make_cipher("hera-128a", seed=2, device="cpu")
    ref = ref_make_cipher("hera-128a", seed=2)
    m = np.random.default_rng(0).uniform(-8, 8, (5, 16)).astype(np.float32)
    enc = ci.encode(m, 1024.0)
    np.testing.assert_array_equal(
        enc.numpy(), np.asarray(ref.encode(m, 1024.0)).astype(np.int64))
    np.testing.assert_array_equal(
        ci.decode(enc, 1024.0).numpy(),
        np.asarray(ref.decode(ref.encode(m, 1024.0), 1024.0)))
    cb = CipherBatch("hera-128a", seed=2, device="cpu")
    assert len(cb) == 0
    cb.add_sessions(3)
    assert len(cb) == 3
