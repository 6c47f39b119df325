"""The port's threefry XOF and its ``threefry`` and ``cached`` producers
against the JAX package: words (the seed quirk included), every constants
plane, the cache's statistics after the reference's call sequences, the
registry report, the cipher gaps (coupled keystream, producer swap,
session cipher) and ``FarmPipeline.in_flight``.  All exact."""

import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import producer as RP  # noqa: E402
from repro.core.cipher import CipherBatch as RefBatch  # noqa: E402
from repro.core.cipher import make_cipher as ref_make_cipher  # noqa: E402
from repro.core.engine import make_engine as ref_make_engine  # noqa: E402
from repro.core.farm import KeystreamFarm as RefFarm  # noqa: E402
from repro.core.farm import pack_windows as ref_pack_windows  # noqa: E402
from repro.core.params import get_params as ref_params  # noqa: E402
from repro.crypto import xof as RX  # noqa: E402

from repro_torch.core import producer as TP  # noqa: E402
from repro_torch.core.cipher import CipherBatch, make_cipher  # noqa: E402
from repro_torch.core.engine import make_engine  # noqa: E402
from repro_torch.core.farm import KeystreamFarm, pack_windows  # noqa: E402
from repro_torch.core.params import get_params  # noqa: E402
from repro_torch.crypto import xof as TX  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CTRS = np.array([0, 1, 65535, 2**16 * 3 + 7], np.uint32)


def _nonces(count=5, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (count, 16),
                                                dtype=np.uint8)


def _tf(base, package="port"):
    get = get_params if package == "port" else ref_params
    return dataclasses.replace(get(base), xof="threefry")


def _i64(x):
    return None if x is None else np.asarray(x).astype(np.int64)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# words
# ---------------------------------------------------------------------------
def test_root_key_is_the_reference_key_data():
    for nonce in np.concatenate([_nonces(8), np.full((1, 16), 255, np.uint8),
                                 np.zeros((1, 16), np.uint8)]):
        want = np.asarray(jax.random.key_data(RX.threefry_root_key(nonce)))
        np.testing.assert_array_equal(TX.threefry_root_key(nonce), want)


@pytest.mark.parametrize("n_words", [1, 3, 16, 96, 1025])
def test_threefry_words_match_reference(n_words):
    nonces = _nonces()
    for nonce in nonces:                       # single stream
        want = np.asarray(RX.threefry_xof_words(nonce, CTRS, n_words))
        got = TX.threefry_xof_words(nonce, CTRS, n_words, device="cpu")
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        got = TX.xof_words("threefry", nonce, CTRS, n_words, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # batched: lanes from all five nonces, every counter
    sids = np.repeat(np.arange(5), CTRS.size)
    ctrs = np.tile(CTRS, 5)
    ref_roots = jnp.stack([RX.threefry_root_key(n) for n in nonces])
    want = np.asarray(RX.threefry_xof_words_batched(
        ref_roots[sids], jnp.asarray(ctrs), n_words))
    roots = torch.as_tensor(np.stack([TX.threefry_root_key(n)
                                      for n in nonces]).astype(np.int64))
    got = TX.threefry_xof_words_batched(roots[sids], ctrs, n_words)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_aes_single_stream_words_match_reference():
    for nonce in _nonces(2, seed=1):
        for n_words in (1, 7, 96):
            want = np.asarray(RX.xof_words("aes", nonce, CTRS, n_words))
            got = TX.xof_words("aes", nonce, CTRS, n_words, device="cpu")
            np.testing.assert_array_equal(got.numpy(),
                                          want.astype(np.int64))
    with pytest.raises(ValueError, match="unknown XOF backend"):
        TX.make_xof("chacha")


def test_threefry_seed_quirk():
    """The reference keeps only the low 32 bits of its 63-bit seed: nonce
    bytes 4-15 do not reach the stream, bytes 0-3 do."""
    nonce = _nonces(1, seed=4)[0]
    base = TX.threefry_xof_words(nonce, CTRS, 16, device="cpu").numpy()
    for byte, changes in ((5, False), (9, False), (0, True), (3, True)):
        flipped = nonce.copy()
        flipped[byte] ^= 0x5A
        got = TX.threefry_xof_words(flipped, CTRS, 16, device="cpu").numpy()
        want = np.asarray(RX.threefry_xof_words(flipped, CTRS, 16))
        np.testing.assert_array_equal(got, want.astype(np.int64))
        assert (not np.array_equal(got, base)) == changes, byte


# ---------------------------------------------------------------------------
# the threefry producer, plane by plane
# ---------------------------------------------------------------------------
def _threefry_planes(base, plane, nonces, sids, ctrs):
    ref = RP.make_producer("threefry", _tf(base, "ref"))
    rt = ref.stack_tables([ref.session_material(n) for n in nonces])
    want = ref.produce(rt, sids.astype(np.int32), ctrs.astype(np.uint32),
                       plane)
    port = TP.make_producer("threefry", _tf(base), device="cpu")
    pt = port.stack_tables([port.session_material(n) for n in nonces])
    got = port.produce(pt, sids, ctrs, plane)
    return got, want


@pytest.mark.parametrize("base", ["rubato-128s", "pasta-128s"])
@pytest.mark.parametrize("plane", ["all", "vector", "matrix"])
def test_threefry_producer_planes_match_reference(base, plane):
    rng = np.random.default_rng(5)
    nonces = _nonces(3, seed=6)
    sids = rng.integers(0, 3, 8)
    ctrs = rng.integers(0, 2**16, 8)
    got, want = _threefry_planes(base, plane, nonces, sids, ctrs)
    assert set(got) == set(want)
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(got[k].numpy(), _i64(want[k]))


def test_threefry_batch_matches_reference_keystream():
    """rubato-128s on threefry as tests/test_farm.py builds it: a pool's
    batched keystream (noise on) equals the reference's, lane for lane."""
    p_ref = dataclasses.replace(ref_params("rubato-128s"),
                                name="rubato-128s-tf", xof="threefry")
    p = dataclasses.replace(get_params("rubato-128s"),
                            name="rubato-128s-tf", xof="threefry")
    ref = RefBatch(p_ref, seed=5)
    ref.add_sessions(3)
    port = CipherBatch(p, key=np.asarray(ref.key), device="cpu")
    for s in ref.sessions:
        port.add_session(s.nonce)
    assert port.producer.name == "threefry"
    rng = np.random.default_rng(1)
    sids = rng.integers(0, 3, 8)
    ctrs = rng.integers(0, 2**16, 8)
    np.testing.assert_array_equal(
        port.keystream(sids, ctrs).numpy(),
        np.asarray(ref.keystream(sids, ctrs)).astype(np.int64))


def test_chip_smoke_threefry_digests_are_the_reference():
    """The SHA-256 digests chip_smoke.py holds the card against are the
    JAX reference's (and the port's CPU path gives them too)."""
    cs = _chip_smoke()
    for base in cs.THREEFRY_PRESETS:
        p_ref = _tf(base, "ref")
        nonces, key, sids, ctrs = cs.threefry_lanes(p_ref)
        sids, ctrs = sids[:cs.DIGEST_LANES], ctrs[:cs.DIGEST_LANES]
        ref = RP.make_producer("threefry", p_ref)
        rt = ref.stack_tables([ref.session_material(n) for n in nonces])
        words = RX.threefry_xof_words_batched(
            rt.device[0][jnp.asarray(sids)], jnp.asarray(ctrs, jnp.uint32),
            p_ref.xof_words_per_block())
        c = ref.produce(rt, sids.astype(np.int32), ctrs.astype(np.uint32))
        z = ref_make_engine("ref", p_ref, jnp.asarray(key)) \
            .keystream_from_constants(c["rc"], c["noise"], c.get("mats"))
        planes = [c[k] for k in ("rc", "noise", "mats")
                  if c.get(k) is not None]
        want = cs.THREEFRY_GOLDEN[base]
        assert cs.digest(words) == want["words"]
        assert cs.digest(*planes) == want["planes"]
        assert cs.digest(z) == want["keystream"]
        # the port's plain path, from the same lanes
        p = _tf(base)
        port = TP.make_producer("threefry", p, device="cpu")
        pt = port.stack_tables([port.session_material(n) for n in nonces])
        roots = pt.device[0][torch.as_tensor(sids)]
        assert cs.digest(TX.threefry_xof_words_batched(
            roots, ctrs, p.xof_words_per_block())) == want["words"]
        pc = port.produce(pt, sids, ctrs)
        assert cs.digest(*[pc[k] for k in ("rc", "noise", "mats")
                           if pc.get(k) is not None]) == want["planes"]
        pz = make_engine("ref", p, key, device="cpu") \
            .keystream_from_constants(pc["rc"], pc["noise"], pc["mats"])
        assert cs.digest(pz) == want["keystream"]


# ---------------------------------------------------------------------------
# registry report
# ---------------------------------------------------------------------------
def test_registry_and_caps_match_reference():
    assert TP.registered_producers() == RP.registered_producers() \
        == ("aes", "cached", "threefry")
    mine, theirs = TP.producer_caps(), RP.producer_caps()
    for name in theirs:
        for field in ("name", "available", "stream", "memoizes"):
            assert getattr(mine[name], field) == getattr(theirs[name], field)
    for base in ("hera-128a", "pasta-128s"):
        assert TP.compatible_producers(get_params(base)) == \
            RP.compatible_producers(ref_params(base)) == ("aes", "cached")
        assert TP.compatible_producers(_tf(base)) == \
            RP.compatible_producers(_tf(base, "ref")) == \
            ("cached", "threefry")
    # no tuner in the port: "auto" is the preset's declared stream
    assert TP.resolve_producer("auto", get_params("hera-80")) == "aes"
    assert TP.resolve_producer("auto", _tf("hera-80")) == "threefry"
    with pytest.raises(ValueError, match="unknown constants producer"):
        TP.resolve_producer("chacha", get_params("hera-80"))
    with pytest.raises(ValueError, match="cannot wrap itself"):
        TP.make_producer("cached", get_params("hera-80"), device="cpu",
                         inner="cached")
    table = TP.describe().splitlines()
    assert table[0].split()[:4] == ["producer", "available", "stream",
                                    "memoizes"]
    assert [r.split()[0] for r in table[2:]] == ["aes", "cached", "threefry"]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.producer"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0 and out.stdout.strip() == TP.describe()


# ---------------------------------------------------------------------------
# the cached producer (call sequences of tests/test_producer.py)
# ---------------------------------------------------------------------------
def _pools(name, seed, producer_ref="cached", producer_port="cached",
           sessions=1):
    """A reference pool and its port twin: same key, nonces and rng."""
    ref = RefBatch(name, seed=seed, producer=producer_ref)
    port = CipherBatch(name, seed=seed, producer=producer_port, device="cpu")
    ref.add_sessions(sessions)
    port.add_sessions(sessions)
    for r, p in zip(ref.sessions, port.sessions):
        np.testing.assert_array_equal(r.nonce, p.nonce)
    return ref, port


def _same(port_z, ref_z):
    np.testing.assert_array_equal(port_z.numpy(),
                                  np.asarray(ref_z).astype(np.int64))


def _stats(prod):
    return {k: prod.cache_stats()[k] for k in ("hits", "misses", "entries")}


def test_cached_hits_on_repeat_window():
    ref, port = _pools("rubato-128s", 9, sessions=2)
    sids, ctrs = np.array([0, 1, 0, 1]), np.array([0, 0, 1, 1])
    for _ in range(2):
        z = port.keystream(sids, ctrs)
        _same(z, ref.keystream(sids, ctrs))
        assert _stats(port.producer) == _stats(ref.producer)
    assert _stats(port.producer) == {"hits": 1, "misses": 1, "entries": 1}
    assert port.producer.cache_stats()["hit_rate"] == 0.5


def test_cached_invalidates_on_rotation():
    ref, port = _pools("rubato-128s", 10)
    ctrs, sids = np.arange(4), np.zeros(4, np.int64)
    z_old = port.keystream(sids, ctrs)
    ref.keystream(sids, ctrs)
    ref.rotate_session(0)
    port.rotate_session(0)
    np.testing.assert_array_equal(port.sessions[0].nonce,
                                  ref.sessions[0].nonce)
    z_new = port.keystream(sids, ctrs)
    _same(z_new, ref.keystream(sids, ctrs))
    assert not torch.equal(z_old, z_new)
    _same(port.session_cipher(0).keystream(ctrs),
          ref.session_cipher(0).keystream(jnp.asarray(ctrs, jnp.uint32)))
    assert _stats(port.producer) == _stats(ref.producer)
    assert port.producer.cache_stats()["misses"] == 2


@pytest.mark.parametrize("rotate", [False, True])
def test_cached_keys_on_plane_kind(rotate):
    """Vector and matrix planes of one window are distinct entries, and a
    rotated session's matrix plane misses."""
    p, p_ref = get_params("pasta-128s"), ref_params("pasta-128s")
    prod, rprod = TP.CachedProducer(p, device="cpu"), RP.CachedProducer(p_ref)
    port = CipherBatch(p, seed=41, producer=prod, device="cpu")
    ref = RefBatch(p_ref, seed=41, producer=rprod)
    port.add_session()
    ref.add_session()
    sids, ctrs = np.zeros(2, np.int64), np.arange(2)
    for b in ((port, ref) if rotate else ()):
        b.producer.produce(b.xof_tables(), sids, ctrs, "matrix")
        b.rotate_session(0)
    for plane in ("vector", "matrix", "vector", "matrix"):
        got = prod.produce(port.xof_tables(), sids, ctrs, plane)
        want = rprod.produce(ref.xof_tables(), sids.astype(np.int32),
                             ctrs.astype(np.uint32), plane)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(_i64(got[k]), _i64(want[k]))
        assert _stats(prod) == _stats(rprod)
    assert _stats(prod)["hits"] == 2


def test_cached_lru_eviction():
    p, p_ref = get_params("hera-128a"), ref_params("hera-128a")
    prod = TP.CachedProducer(p, device="cpu", max_entries=2)
    rprod = RP.CachedProducer(p_ref, max_entries=2)
    port = CipherBatch(p, seed=12, producer=prod, device="cpu")
    ref = RefBatch(p_ref, seed=12, producer=rprod)
    port.add_session()
    ref.add_session()
    for base in (0, 4, 8, 0):
        ctrs = np.array([base, base + 1])
        _same(port.keystream(np.zeros(2, np.int64), ctrs),
              ref.keystream(np.zeros(2, np.int64), ctrs))
        assert _stats(prod) == _stats(rprod)
    assert _stats(prod) == {"hits": 0, "misses": 4, "entries": 2}


def test_cached_instance_shared_across_pools_keys_on_tables():
    p = get_params("rubato-128s")
    prod = TP.CachedProducer(p, device="cpu")
    cb = CipherBatch(p, seed=30, producer=prod, device="cpu")
    cb.add_session()
    ctrs, sids = np.arange(3), np.zeros(3, np.int64)
    z_pool = cb.keystream(sids, ctrs)
    from repro_torch.core.cipher import Cipher

    ci = Cipher(p, cb.key, np.arange(16, dtype=np.uint8), producer=prod,
                device="cpu")
    z_other = ci.keystream(ctrs)
    assert not torch.equal(z_other, z_pool)
    assert torch.equal(cb.keystream(sids, ctrs), z_pool)
    assert torch.equal(ci.keystream(ctrs), z_other)
    assert _stats(prod) == {"hits": 2, "misses": 2, "entries": 2}
    ref_z = ref_make_cipher("rubato-128s", key=np.asarray(cb.key),
                            nonce=np.arange(16, dtype=np.uint8)) \
        .keystream(jnp.arange(3, dtype=jnp.uint32))
    _same(z_other, ref_z)


def test_set_producer_rejects_cross_stream_and_swaps_in_place():
    cb = CipherBatch("hera-128a", seed=1, device="cpu")
    cb.add_session()
    with pytest.raises(ValueError, match="stream"):
        cb.set_producer("threefry")
    assert cb.producer.name == "aes"
    assert CipherBatch("hera-128a", producer="threefry",
                       device="cpu").producer.name == "threefry"
    ref, port = _pools("rubato-128s", 13, producer_ref=None,
                       producer_port=None)
    for b in (ref, port):
        b.sessions[0].take_window(6)
    sids, ctrs = np.zeros(4, np.int64), np.arange(4)
    z_aes = port.keystream(sids, ctrs)
    assert port.set_producer("cached").name == "cached"
    ref.set_producer("cached")
    assert port.sessions[0].next_ctr == 6
    for _ in range(2):
        z = port.keystream(sids, ctrs)
        assert torch.equal(z, z_aes)
        _same(z, ref.keystream(sids, ctrs))
    assert _stats(port.producer) == _stats(ref.producer)
    assert _stats(port.producer)["hits"] == 1


# ---------------------------------------------------------------------------
# cipher gaps and the pipeline's in-flight count
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,producer", [("rubato-128s", "cached"),
                                           ("pasta-128s", None)])
def test_keystream_coupled_matches_reference(name, producer):
    ci = make_cipher(name, seed=2, producer=producer, device="cpu")
    ref = ref_make_cipher(name, seed=2, producer=producer)
    ctrs = np.arange(3)
    z = ci.keystream_coupled(ctrs)
    assert torch.equal(z, ci.keystream(ctrs))
    _same(z, ref.keystream_coupled(jnp.asarray(ctrs, jnp.uint32)))


def test_session_cipher_matches_reference():
    ref, port = _pools("hera-80", 3, producer_ref=None, producer_port=None,
                       sessions=3)
    for i in range(3):
        ci = port.session_cipher(i)
        assert ci.producer == port.producer.name and ci.device == port.device
        _same(ci.keystream(np.arange(5)),
              ref.session_cipher(i).keystream(jnp.arange(5,
                                                         dtype=jnp.uint32)))


@pytest.mark.parametrize("depth,matrix_depth", [(1, 1), (2, 1), (2, 3)])
def test_pipeline_in_flight_matches_reference(depth, matrix_depth):
    ref, port = _pools("pasta-128s", 4, producer_ref=None,
                       producer_port=None, sessions=2)
    rp = RefFarm(ref, engine="ref", depth=depth,
                 matrix_depth=matrix_depth).pipeline()
    pp = KeystreamFarm(port, depth=depth,
                       matrix_depth=matrix_depth).pipeline()
    sids, ctrs = np.array([0, 1, 1, 0, 0, 1]), np.arange(6)
    counts = []
    for rplan, pplan in zip(ref_pack_windows(sids, ctrs, 2),
                            pack_windows(sids, ctrs, 2)):
        r_out, p_out = rp.push(rplan), pp.push(pplan)
        assert len(r_out) == len(p_out)
        for (_, rz), (_, pz) in zip(r_out, p_out):
            _same(pz, rz)
        counts.append((pp.in_flight(), rp.in_flight()))
    assert all(a == b for a, b in counts)
    assert (counts[-1][0] > 0) == (depth > 1 or matrix_depth > 1)
    for (_, rz), (_, pz) in zip(rp.drain(), pp.drain()):
        _same(pz, rz)
    assert pp.in_flight() == rp.in_flight() == 0
