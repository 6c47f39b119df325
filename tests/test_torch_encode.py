"""The port's encrypt/decrypt boundary against the JAX reference on
plaintexts its fixed-point encoding cannot hold: outside the encodable
range, at and beyond the int32 range of round(m·Δ), ±inf and NaN.

The reference casts float32 to int32 through XLA (NaN -> 0, saturating)
and wraps its words in uint32; the port must give the same uint32 word
and decrypt to the same float32, bit for bit, through `Cipher`,
`CipherBatch`, the farm's streams and the `HHEServer` ops.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core.cipher import CipherBatch as RefBatch  # noqa: E402
from repro.core.cipher import decode_fixed as ref_decode  # noqa: E402
from repro.core.cipher import encode_fixed as ref_encode  # noqa: E402
from repro.core.cipher import make_cipher as ref_make_cipher  # noqa: E402
from repro.core.params import get_params as ref_get_params  # noqa: E402
from repro.serve.hhe_loop import HHERequest as RefRequest  # noqa: E402
from repro.serve.hhe_loop import HHEServer as RefServer  # noqa: E402

from repro_torch.core.cipher import (  # noqa: E402
    decode_fixed,
    encode_fixed,
    make_cipher,
)
from repro_torch.core.convert import batch_from_reference  # noqa: E402
from repro_torch.core.farm import KeystreamFarm, plan_windows  # noqa: E402
from repro_torch.core.params import get_params  # noqa: E402
from repro_torch.serve.hhe_loop import HHERequest, HHEServer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PRESETS = ["hera-128a", "rubato-128l", "pasta-128l"]
DELTA = 1024.0
# round(m·Δ) of each: out of Z_q either side, not finite, the encodable
# range's edges at rubato-128l (the first ten are chip_smoke.py's
# ENCODE_PLAINTEXTS), the int32 edges and past them
EDGES = [-1e6, 1e6, -1e5, 3e9, -3e9, float("nan"), float("inf"),
         float("-inf"), 16376.0, -16377.0, 1e5, 2.0**31 / DELTA,
         -(2.0**31) / DELTA, 2.0**31 / DELTA - 1.0, 1e30, -1e30, 0.0, -0.0]


def _bits(x):
    """float32 values as their int32 bit patterns (NaN compares too)."""
    return np.asarray(x, np.float32).view(np.int32)


def _msgs(l, values):
    return np.repeat(np.asarray(values, np.float32)[:, None], l, axis=1)


@pytest.fixture(scope="module")
def ciphers():
    """Per preset: the reference's and the port's make_cipher(name,
    seed=3), and the reference's ciphertext words and decrypted floats of
    every edge, one lane each at counter 0 (one call: one shape for the
    reference's eager ops to compile)."""
    out = {}
    for name in PRESETS:
        ref = ref_make_cipher(name, seed=3)
        ctrs = jnp.zeros(len(EDGES), jnp.uint32)
        ct = np.asarray(ref.encrypt(_msgs(ref.params.l, EDGES), ctrs))
        pt = np.asarray(ref.decrypt(ct, ctrs))
        out[name] = (ref, make_cipher(name, seed=3, device="cpu"), ct, pt)
    return out


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("i", range(len(EDGES)),
                         ids=[repr(m) for m in EDGES])
def test_cipher_encrypt_decrypt_match_reference(ciphers, name, i):
    _, port, ct_ref, pt_ref = ciphers[name]
    ct = port.encrypt(_msgs(port.params.l, [EDGES[i]]), np.zeros(1))
    np.testing.assert_array_equal(ct.numpy(),
                                  ct_ref[i:i + 1].astype(np.int64))
    back = port.decrypt(ct_ref[i:i + 1], np.zeros(1)).numpy()
    np.testing.assert_array_equal(_bits(back), _bits(pt_ref[i:i + 1]))


def test_the_motivating_rows_agree(ciphers):
    """hera-128a at -1e6, NaN and 3e9, rubato-128l at -1e5, pasta-128l at
    +inf: word (0, 0), 1 lane, counter 0."""
    for name, m, word in [("hera-128a", -1e6, 3305308792),
                          ("hera-128a", float("nan"), 34341496),
                          ("hera-128a", 3e9, 1913455222),
                          ("rubato-128l", -1e5, 4197424820),
                          ("pasta-128l", float("inf"), 2124354704)]:
        port = ciphers[name][1]
        ct = port.encrypt(_msgs(port.params.l, [m]), np.zeros(1))
        assert int(ct[0, 0]) == word, (name, m)


@pytest.mark.parametrize("name", PRESETS)
def test_encode_and_decode_match_reference_on_every_word(name):
    """encode_fixed on the float32 edges and a spread of finite values;
    decode_fixed on every uint32 region: [0, q), [q, 2^31), [2^31, 2^32)."""
    mod = get_params(name).mod
    ref_mod = ref_get_params(name).mod
    rng = np.random.default_rng(7)
    m = np.concatenate([np.asarray(EDGES, np.float32),
                        rng.standard_normal(512).astype(np.float32)
                        * np.float32(10.0) ** rng.integers(-3, 10, 512)])
    for delta in (DELTA, 4096.0, 3.0):
        want = np.asarray(ref_encode(ref_mod, m, delta)).astype(np.int64)
        np.testing.assert_array_equal(encode_fixed(mod, m, delta).numpy(),
                                      want)
    words = np.concatenate([
        rng.integers(0, mod.q, 256), rng.integers(mod.q, 2**31, 256),
        rng.integers(2**31, 2**32, 256),
        [0, mod.q // 2, mod.q // 2 + 1, mod.q - 1, mod.q, 2**31 - 1, 2**31,
         2**31 + mod.q, 2**32 - 1]]).astype(np.uint32)
    want = np.asarray(ref_decode(ref_mod, jnp.asarray(words), DELTA))
    got = decode_fixed(mod, torch.as_tensor(words.astype(np.int64)),
                       DELTA).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _pair(name, sessions=3, seed=5):
    ref = RefBatch(name, seed=seed, engine="ref")
    ref.add_sessions(sessions)
    port = batch_from_reference(
        name, np.asarray(ref.key), np.stack([s.nonce for s in ref.sessions]),
        device="cpu")
    return ref, port


@pytest.mark.parametrize("name", PRESETS)
def test_cipher_batch_and_farm_streams_match_reference(name):
    ref, port = _pair(name)
    l = port.params.l
    lanes = len(EDGES)
    sids = np.arange(lanes) % 3
    ctrs = np.arange(lanes)
    msg = _msgs(l, EDGES)
    ct_ref = np.asarray(ref.encrypt(msg, jnp.asarray(sids),
                                    jnp.asarray(ctrs, jnp.uint32)))
    ct = port.encrypt(msg, sids, ctrs)
    np.testing.assert_array_equal(ct.numpy(), ct_ref.astype(np.int64))
    back_ref = np.asarray(ref.decrypt(ct_ref, jnp.asarray(sids),
                                      jnp.asarray(ctrs, jnp.uint32)))
    back = port.decrypt(ct_ref, sids, ctrs).numpy()
    np.testing.assert_array_equal(_bits(back), _bits(back_ref))
    # the farm's streams go through the same boundary
    farm = KeystreamFarm(port)
    plans = plan_windows(port.sessions, 2, window=6)
    msgs = [_msgs(l, np.resize(EDGES, p.session_ids.shape[0]))
            for p in plans]
    cts = [c for _, c in farm.encrypt_stream(zip(plans, msgs))]
    for p, m, c in zip(plans, msgs, cts):
        want = port.encrypt(m, p.session_ids, p.block_ctrs)
        np.testing.assert_array_equal(c.numpy(), want.numpy())
    back = [b for _, b in farm.decrypt_stream(zip(plans, cts))]
    for p, c, b in zip(plans, cts, back):
        want = port.decrypt(c, p.session_ids, p.block_ctrs)
        np.testing.assert_array_equal(_bits(b.numpy()), _bits(want.numpy()))


@pytest.mark.parametrize("name", PRESETS)
def test_server_encrypt_and_decrypt_ops_match_reference(name):
    ref, port = _pair(name)
    l, q = port.params.l, port.params.mod.q
    rs = RefServer(ref, window=8, engine="ref", depth=2)
    ps = HHEServer(port, window=8, depth=2)
    rng = np.random.default_rng(1)
    # one block count for every request: one shape a reference op compiles
    words = np.concatenate([rng.integers(0, 2**32, (4, l)),
                            np.full((1, l), 2**32 - 1),
                            np.full((1, l), q)]).astype(np.uint32)
    reqs = [(0, "encrypt", _msgs(l, EDGES[:6])),
            (1, "encrypt", _msgs(l, EDGES[6:12])),
            (2, "encrypt", _msgs(l, EDGES[12:])),
            (2, "decrypt", words),
            (0, "decrypt_tokens", words[::-1]),
            (1, "encrypt_tokens", rng.integers(0, 2**32, (6, l))
             .astype(np.uint32))]
    for sid, op, payload in reqs:
        for srv, Req in ((rs, RefRequest), (ps, HHERequest)):
            srv.submit(Req(sid, op=op, payload=payload,
                           blocks=payload.shape[0]))
    r_resp, p_resp = rs.flush(), ps.flush()
    assert len(r_resp) == len(p_resp) == len(reqs)
    for r, p in zip(r_resp, p_resp):
        want = np.asarray(r.result)
        assert p.result.dtype == want.dtype, r.request.op
        if want.dtype == np.float32:
            np.testing.assert_array_equal(_bits(p.result), _bits(want))
        else:
            np.testing.assert_array_equal(p.result, want)
    # decrypting the server's ciphertexts of the edges gives the
    # reference's floats back
    for r, p in zip(r_resp[:3], p_resp[:3]):
        back = port.decrypt(p.result, np.full(p.result.shape[0],
                                              p.request.session_id),
                            p.block_ctrs).numpy()
        want = np.asarray(ref.decrypt(
            np.asarray(r.result), jnp.full(len(r.block_ctrs),
                                           r.request.session_id),
            jnp.asarray(r.block_ctrs, jnp.uint32)))
        np.testing.assert_array_equal(_bits(back), _bits(want))


def test_chip_smoke_encode_digests_are_the_reference(ciphers):
    """The constants chip_smoke.py holds the card's encrypt and decrypt
    against are the JAX reference's, and the port's CPU path gives them."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert sorted(cs.ENCODE_GOLDEN) == sorted(PRESETS)
    n = len(cs.ENCODE_PLAINTEXTS)
    np.testing.assert_array_equal(_bits(cs.ENCODE_PLAINTEXTS),
                                  _bits(EDGES[:n]))
    for name, want in cs.ENCODE_GOLDEN.items():
        # the reference's rows of the plaintexts, each at counter 0
        ct, pt = ciphers[name][2][:n], ciphers[name][3][:n]
        assert cs.digest(ct) == want["ct"], name
        assert cs.digest(_bits(pt)) == want["pt"], name
        assert [int(x) for x in ct[:, 0]] == want["word0"], name
        got_ct, got_pt = cs.encode_edges(torch.device("cpu"), name)
        assert cs.digest(got_ct) == want["ct"], name
        assert cs.digest(_bits(got_pt.numpy())) == want["pt"], name
