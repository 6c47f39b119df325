"""The port's constants producer against the JAX `aes` producer: AES
blocks, XOF words, and the rc / noise / matrix planes word for word, for
every preset, on lanes drawn from several sessions."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.producer import make_producer as ref_make_producer  # noqa: E402
from repro.core.params import get_params as ref_params  # noqa: E402
from repro.crypto import sampler as RSMP  # noqa: E402
from repro.crypto.aes import aes128_key_expand as ref_key_expand  # noqa: E402
from repro.crypto.xof import aes_xof_words_batched as ref_xof  # noqa: E402
from repro.kernels.aes.ref import aes_ctr_ref as ref_aes_ctr  # noqa: E402

from repro_torch.core.params import REGISTRY, get_params  # noqa: E402
from repro_torch.core.producer import make_producer  # noqa: E402
from repro_torch.crypto import sampler as TSMP  # noqa: E402
from repro_torch.crypto.aes import _SBOX_NP, aes128_key_expand  # noqa: E402
from repro_torch.kernels.aes.ops import (  # noqa: E402
    XOF_THREADS,
    aes_ctr_kernel_apply,
    aes_xof_words,
    t_table,
    xof_launch_shape,
)
from repro_torch.kernels.build import from_u32_bits  # noqa: E402

PRESETS = sorted(REGISTRY)
SESSIONS = 3


def _lanes(name):
    return 2 if name == "pasta-128l" else 8


def _pool(name, seed=0):
    rng = np.random.default_rng(seed)
    nonces = rng.integers(0, 256, (SESSIONS, 16), dtype=np.uint8)
    lanes = _lanes(name)
    sids = rng.integers(0, SESSIONS, lanes)
    ctrs = rng.integers(0, 2**16, lanes)
    return nonces, sids, ctrs


@functools.lru_cache(maxsize=None)
def _ref_constants(name, plane):
    nonces, sids, ctrs = _pool(name)
    prod = ref_make_producer("aes", ref_params(name))
    tables = prod.stack_tables([prod.session_material(n) for n in nonces])
    out = prod.produce(tables, sids.astype(np.int32), ctrs.astype(np.uint32),
                       plane)
    return {k: None if v is None else np.asarray(v).astype(np.int64)
            for k, v in out.items()}


def test_key_expansion_and_sbox_are_the_reference():
    from repro.crypto.aes import _SBOX_NP as REF_SBOX

    np.testing.assert_array_equal(_SBOX_NP, REF_SBOX)
    rng = np.random.default_rng(0)
    for _ in range(4):
        k = rng.integers(0, 256, 16, dtype=np.uint8)
        np.testing.assert_array_equal(aes128_key_expand(k), ref_key_expand(k))


def test_aes_blocks_match_reference():
    """The AES kernel wrapper's plain version vs the reference's
    `aes_ctr_ref`, full 32-bit counters."""
    rng = np.random.default_rng(1)
    rk = aes128_key_expand(rng.integers(0, 256, 16, dtype=np.uint8))
    n12 = rng.integers(0, 256, 12, dtype=np.uint8)
    ctr = rng.integers(0, 2**32, 300, dtype=np.uint64)
    got = aes_ctr_kernel_apply(rk, n12, torch.as_tensor(ctr.astype(np.int64)))
    want = np.asarray(ref_aes_ctr(rk, n12, ctr.astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_words", [1, 5, 112, 333])
def test_xof_words_match_reference(n_words):
    nonces, _, _ = _pool("hera-80")
    rng = np.random.default_rng(n_words)
    sids = rng.integers(0, SESSIONS, 6)
    ctrs = rng.integers(0, 2**16, 6)
    rk = np.stack([aes128_key_expand(n) for n in nonces])
    got = aes_xof_words(torch.as_tensor(rk), torch.as_tensor(nonces[:, :12]),
                        torch.as_tensor(sids), torch.as_tensor(ctrs), n_words)
    want = np.asarray(ref_xof(rk[sids], nonces[sids, :12],
                              ctrs.astype(np.uint32), n_words))
    np.testing.assert_array_equal(from_u32_bits(got).numpy(),
                                  want.astype(np.int64))


# ---------------------------------------------------------------------------
# The CUDA AES kernel's T-table rounds and work mapping, modelled in numpy
# ---------------------------------------------------------------------------
_M32 = np.uint64(0xFFFFFFFF)


def _rotl(v, n):
    return ((v << np.uint64(n)) | (v >> np.uint64(32 - n))) & _M32


def _byte_perm(x, y, sel):
    """CUDA __byte_perm: result byte n is byte (sel >> 4n) & 7 of the
    eight bytes of (x, y)."""
    out = np.zeros_like(x)
    for n in range(4):
        k = (sel >> (4 * n)) & 7
        src = x if k < 4 else y
        out |= ((src >> np.uint64(8 * (k % 4))) & np.uint64(0xFF)) \
            << np.uint64(8 * n)
    return out


def _model_encrypt(s, rk, bank):
    """csrc/aes.cu aes128_encrypt on column words s (4, m) with round-key
    words rk (m, 44).  The shared table gives entry x 256 bytes: 32
    replicas of T0[x], then 32 of T1[x] = rotl(T0[x], 8); a thread reads
    the replica in its bank at byte (x << 8) | 4·bank, formed by one
    byte permute, plus 128 for T1."""
    t0 = t_table().astype(np.uint64)
    words = np.stack([np.repeat(t0[:, None], 32, 1),
                      np.repeat(_rotl(t0, 8)[:, None], 32, 1)], 1)
    tab = words.reshape(-1)                       # word (byte offset / 4)
    boff = 4 * bank.astype(np.uint64)

    def lds(off):
        return tab[(off >> np.uint64(2)).astype(np.int64)]

    def entry(w, k):
        return _byte_perm(w, boff, 0x5504 | (k << 4))

    t1 = np.uint64(128)
    w = [s[c] ^ rk[:, c] for c in range(4)]
    for r in range(1, 10):
        nxt = []
        for c in range(4):
            a, b, cc, d = (w[(c + i) % 4] for i in range(4))
            hi = lds(entry(cc, 2)) ^ lds(t1 + entry(d, 3))
            nxt.append(lds(entry(a, 0)) ^ lds(t1 + entry(b, 1))
                       ^ _rotl(hi, 16) ^ rk[:, 4 * r + c])
        w = nxt
    out = []
    for c in range(4):
        a, b, cc, d = (w[(c + i) % 4] for i in range(4))
        lo = _byte_perm(lds(entry(a, 0)), lds(entry(b, 1)), 0x0051)
        hi = _byte_perm(lds(entry(cc, 2)), lds(entry(d, 3)), 0x6200)
        out.append(_byte_perm(lo, hi, 0x7610) ^ rk[:, 40 + c])
    return out


def _le_words(b):
    """(..., 4k) bytes -> (..., k) little-endian uint64 words."""
    return np.ascontiguousarray(b, np.uint8).view("<u4").astype(np.uint64)


def _be32_word(ctr):
    """Column word 3 of nonce12 || be32(ctr)."""
    c = ctr.astype(np.uint64)
    return (((c >> np.uint64(24)) & np.uint64(0xFF))
            | (((c >> np.uint64(16)) & np.uint64(0xFF)) << np.uint64(8))
            | (((c >> np.uint64(8)) & np.uint64(0xFF)) << np.uint64(16))
            | ((c & np.uint64(0xFF)) << np.uint64(24)))


def _model_xof(rk_table, n12_table, sids, ctrs, n_words):
    """repro_aes_xof thread for thread: thread blocks of XOF_THREADS, each
    on one lane or a group of whole lanes, thread t at AES block
    t - sub·n_blocks of lane block·group + sub, striding by the block
    size; one 16-byte (four-word) store per AES block."""
    lanes = len(sids)
    n_blocks, group, grid = xof_launch_shape(lanes, n_words)
    t = np.tile(np.arange(XOF_THREADS), grid)
    sub = t // n_blocks
    lane = np.repeat(np.arange(grid), XOF_THREADS) * group + sub
    keep = (sub < group) & (lane < lanes)
    t, sub, lane = t[keep], sub[keep], lane[keep]
    i = t - sub * n_blocks
    rk = _le_words(rk_table.reshape(len(rk_table), 176))[sids[lane]]
    pre = _le_words(n12_table)[sids[lane]]
    out = np.zeros((lanes, n_words), np.uint32)
    written = np.zeros((lanes, n_blocks), np.int64)
    while i.size:
        ctr = (ctrs[lane].astype(np.uint64) * np.uint64(65536)
               + i.astype(np.uint64)) & _M32
        s = [pre[:, 0], pre[:, 1], pre[:, 2], _be32_word(ctr)]
        w = _model_encrypt(s, rk, t % 32)
        for k in range(4):
            col = 4 * i + k
            ok = col < n_words
            out[lane[ok], col[ok]] = w[k][ok]
        np.add.at(written, (lane, i), 1)
        i = i + XOF_THREADS
        more = i < n_blocks
        t, lane, i, rk, pre = t[more], lane[more], i[more], rk[more], pre[more]
    assert (written == 1).all()           # every AES block exactly once
    return out


def test_t_table_round_fips197():
    """The T-table round on FIPS-197 appendix C.1 (through the CTR block
    layout nonce12 || be32(counter))."""
    pt = np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"),
                       np.uint8)
    rk = _le_words(aes128_key_expand(np.arange(16, dtype=np.uint8))
                   .reshape(1, 176))
    ctr = np.array([int.from_bytes(pt[12:].tobytes(), "big")])
    pre = _le_words(pt[:12])
    s = [pre[0:1], pre[1:2], pre[2:3], _be32_word(ctr)]
    w = _model_encrypt(s, rk, np.array([5]))
    got = np.array([v[0] for v in w], np.uint32).astype("<u4").tobytes()
    assert got.hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


@pytest.mark.parametrize("n_words", [1, 115, 1000])
def test_t_table_xof_model_matches_reference(n_words):
    """The kernel's T-table rounds, work mapping and word packing, on 300
    lanes of 3 sessions, equal the reference's XOF words."""
    rng = np.random.default_rng(10 + n_words)
    nonces = rng.integers(0, 256, (SESSIONS, 16), dtype=np.uint8)
    rk = np.stack([aes128_key_expand(n) for n in nonces])
    sids = rng.integers(0, SESSIONS, 300)
    ctrs = rng.integers(0, 2**16, 300)
    got = _model_xof(rk, nonces[:, :12], sids, ctrs, n_words)
    want = np.asarray(ref_xof(rk[sids], nonces[sids, :12],
                              ctrs.astype(np.uint32), n_words))
    np.testing.assert_array_equal(got, want.astype(np.uint32))


# the vector/matrix split only differs from "all" on matrix presets
PLANE_CASES = [(n, "all") for n in PRESETS] + [
    (n, plane) for n in PRESETS if get_params(n).n_matrix_constants
    for plane in ("vector", "matrix")]


@pytest.mark.parametrize("name,plane", PLANE_CASES)
def test_planes_match_reference_producer(name, plane):
    p = get_params(name)
    nonces, sids, ctrs = _pool(name)
    prod = make_producer(None, p, device="cpu")
    tables = prod.stack_tables([prod.session_material(n) for n in nonces])
    got = prod.produce(tables, sids, ctrs, plane)
    want = _ref_constants(name, plane)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("sigma", [1.6, 3.2])
def test_gaussian_table_and_sampler(sigma):
    t, r = TSMP.DGaussTable.build(sigma), RSMP.DGaussTable.build(sigma)
    np.testing.assert_array_equal(t.hi, r.hi)
    np.testing.assert_array_equal(t.lo, r.lo)
    rng = np.random.default_rng(2)
    hi = rng.integers(0, 2**32, 5000, dtype=np.uint64)
    lo = rng.integers(0, 2**32, 5000, dtype=np.uint64)
    # steer a share of draws onto the thresholds themselves
    hi[:64] = r.hi[rng.integers(0, len(r.hi), 64)]
    got = TSMP.discrete_gaussian(torch.as_tensor(hi.astype(np.int64)),
                                 torch.as_tensor(lo.astype(np.int64)), t)
    want = RSMP.discrete_gaussian(hi.astype(np.uint32), lo.astype(np.uint32),
                                  r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stream_sampler_compaction_and_fallback():
    """Stable compaction, including the reference's fallback when fewer
    than n_out words are accepted (words forced into the rejection zone)."""
    mod = get_params("hera-80").mod
    rng = np.random.default_rng(3)
    w = rng.integers(0, 2**32, (4, 40), dtype=np.uint64)
    w[1, ::3] = 2**32 - 1          # rejected: low 28 bits >= q
    w[2, :] = 2**32 - 1            # all rejected -> fallback everywhere
    got = TSMP.uniform_mod_q_stream(torch.as_tensor(w.astype(np.int64)), 24,
                                    mod)
    want = RSMP.uniform_mod_q_stream(w.astype(np.uint32), 24,
                                     ref_params("hera-80").mod)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
