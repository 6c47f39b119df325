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


# ---------------------------------------------------------------------------
# The sampler kernels' wrappers on the CPU, and the uniform kernel's warp
# compaction modelled in numpy
# ---------------------------------------------------------------------------
SAMPLER_SHAPES = [("hera-128a", "rc"), ("rubato-128l", "rc"),
                  ("pasta-128l", "rc"), ("pasta-128l", "mats")]
WORD_KINDS = ("random", "scattered", "all_rejected", "fallback", "high")
STREAM_PAD = TSMP.STREAM_PAD


def _stream_words(name, plane, kind, rows=5, seed=0):
    """(rows, w) uint64 words of one sampler stream: random, or built to
    hit an edge of the compaction."""
    p = get_params(name)
    n_out = p.n_round_constants if plane == "rc" else p.n_matrix_constants
    w = TSMP.words_needed_uniform_stream(n_out)
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (rows, w), dtype=np.uint64)
    rejected = np.uint64(2**32 - 1)          # low `bits` bits >= q
    if kind == "all_rejected":
        words[:] = rejected
    elif kind == "fallback":
        # a cluster of rejections at the front and one at the back, so
        # fewer than n_out are accepted and the tail takes the fallback
        words[:, :5] = rejected
        words[:, -STREAM_PAD - 1:] = rejected
        words[0, 40:60] = rejected
    elif kind == "scattered":
        # rejections inside the chunks, fewer than the pad: every slot
        # after the first shifts, and n_out fill before the row ends
        words[:, 3:w - STREAM_PAD:max(1, w // 12)] = rejected
    elif kind == "high":
        words |= np.uint64(2**31)             # every word >= 2^31
    return n_out, p.mod, words


def _as_words(words, dtype):
    """uint64 word values as the XOF hands them over: int32 bit patterns
    (AES) or int64 values (threefry)."""
    if dtype == torch.int32:
        return torch.as_tensor(words.astype(np.uint32).view(np.int32))
    return torch.as_tensor(words.astype(np.int64))


@pytest.fixture
def no_launches():
    from repro_torch.kernels import build

    build.reset_launches()
    yield
    assert not any(build.LAUNCHES.values())


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("kind", WORD_KINDS)
@pytest.mark.parametrize("name,plane", SAMPLER_SHAPES)
def test_uniform_wrapper_on_cpu_is_the_reference(name, plane, kind, dtype,
                                                 no_launches):
    from repro_torch.kernels.sampler.ops import uniform_kernel_apply

    n_out, mod, words = _stream_words(name, plane, kind,
                                      rows=2 if plane == "mats" else 5)
    got = uniform_kernel_apply(_as_words(words, dtype), n_out, mod)
    want = RSMP.uniform_mod_q_stream(words.astype(np.uint32), n_out,
                                     ref_params(name).mod)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _gauss_words(table, n=600, seed=4):
    """(hi, lo) uint64 draws: random, and equal to a threshold, one below
    it (at hi and at lo), and 0xFFFFFFFF."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 2**32, n, dtype=np.uint64)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64)
    th, tl = table.hi.astype(np.uint64), table.lo.astype(np.uint64)
    k = len(th)
    hi[:k], lo[:k] = th, tl                                  # equal
    fixed = ((th << np.uint64(32)) | tl) - np.uint64(1)      # one below
    hi[k:2 * k] = fixed >> np.uint64(32)
    lo[k:2 * k] = fixed & np.uint64(0xFFFFFFFF)
    hi[2 * k:3 * k], lo[2 * k:3 * k] = th, tl - np.uint64(1) * (tl > 0)
    hi[3 * k:3 * k + 4] = 2**32 - 1
    lo[3 * k:3 * k + 2] = 2**32 - 1
    hi[3 * k + 4:3 * k + 6], lo[3 * k + 4:3 * k + 6] = 0, 0
    return hi.reshape(-1, 60), lo.reshape(-1, 60)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("sigma", [1.6, 3.2])
def test_gauss_wrapper_on_cpu_is_the_reference(sigma, dtype, no_launches):
    from repro_torch.kernels.sampler.ops import gauss_kernel_apply

    t = TSMP.DGaussTable.build(sigma)
    hi, lo = _gauss_words(t)
    got = gauss_kernel_apply(_as_words(hi, dtype), _as_words(lo, dtype), t)
    want = RSMP.discrete_gaussian(hi.astype(np.uint32), lo.astype(np.uint32),
                                  RSMP.DGaussTable.build(sigma))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_producer_builds_its_gaussian_table_once(monkeypatch):
    """One table a producer, the reference's; the kernels' copy on a
    device is uploaded once per device and table."""
    from repro_torch.kernels.sampler import ops as SO

    p = get_params("rubato-128l")
    built = []
    build = TSMP.DGaussTable.build
    monkeypatch.setattr(TSMP.DGaussTable, "build",
                        staticmethod(lambda s: built.append(s) or build(s)))
    prod = make_producer(None, p, device="cpu")
    nonces, sids, ctrs = _pool("rubato-128l")
    tables = prod.stack_tables([prod.session_material(n) for n in nonces])
    for _ in range(2):
        prod.produce(tables, sids, ctrs)
    assert built == [p.sigma]
    want = build(p.sigma)
    assert (prod._gauss.sigma, prod._gauss.tail) == (want.sigma, want.tail)
    np.testing.assert_array_equal(prod._gauss.hi, want.hi)
    np.testing.assert_array_equal(prod._gauss.lo, want.lo)
    thr = SO.device_thresholds(prod._gauss, torch.device("cpu"))
    assert SO.device_thresholds(want, torch.device("cpu")) is thr
    fixed = [(int(h) << 32) | int(lo) for h, lo in zip(want.hi, want.lo)]
    assert [int(v) % 2**64 for v in thr] == fixed
    assert fixed == sorted(fixed)


def test_build_carries_the_sampler_entry_points():
    from repro_torch.kernels import build

    assert "sampler.cu" in build.SOURCES
    assert {"repro_sampler_uniform", "repro_sampler_gauss"} \
        <= set(build._SIGNATURES)
    assert {"sampler_uniform", "sampler_gauss"} <= set(build.LAUNCHES)
    src = (build.CSRC / "sampler.cu").read_text()
    for name in ("sampler_uniform_kernel", "sampler_gauss_kernel",
                 "repro_sampler_uniform", "repro_sampler_gauss"):
        assert name in src
    # the trace's roofline readers match these substrings
    assert "aes_xof_kernel" not in src and "keystream_kernel" not in src


def _kernel_unroll():
    import re

    from repro_torch.kernels import build

    src = (build.CSRC / "sampler.cu").read_text()
    return int(re.search(r"constexpr int kUnroll = (\d+);", src).group(1))


def _model_uniform(words, n_out, mod):
    """sampler_uniform_kernel's warp, vote for vote: chunks of 32·kUnroll
    words, one word a thread per step, the stable slot as the running
    count plus the accepted threads below; stop once n_out are accepted;
    then, if fewer were, the rejected candidates mod q in stream order."""
    unroll = _kernel_unroll()
    mask, q = (1 << mod.bits) - 1, mod.q
    rows, n_words = words.shape
    out = np.full((rows, n_out), -1, np.int64)
    thread = np.arange(32)
    for r in range(rows):
        taken, base = 0, 0
        while base < n_words and taken < n_out:
            for u in range(unroll):
                i = base + 32 * u + thread
                c = np.where(i < n_words,
                             words[r, np.minimum(i, n_words - 1)] & mask, q)
                ok = c < q
                slot = taken + np.cumsum(ok) - ok
                hit = ok & (slot < n_out)
                assert (out[r, slot[hit]] == -1).all()
                out[r, slot[hit]] = c[hit]
                taken += int(ok.sum())
            base += 32 * unroll
        base = 0
        while base < n_words and taken < n_out:
            i = base + thread
            c = words[r, np.minimum(i, n_words - 1)] & mask
            bad = (i < n_words) & (c >= q)
            slot = taken + np.cumsum(bad) - bad
            hit = bad & (slot < n_out)
            out[r, slot[hit]] = c[hit] % q
            taken += int(bad.sum())
            base += 32
    assert (out >= 0).all()                  # every slot written once
    return out


@pytest.mark.parametrize("kind", WORD_KINDS)
@pytest.mark.parametrize("name,plane", SAMPLER_SHAPES)
def test_uniform_kernel_model_is_the_reference(name, plane, kind):
    n_out, mod, words = _stream_words(name, plane, kind,
                                      rows=1 if plane == "mats" else 4,
                                      seed=7)
    got = _model_uniform(words.astype(np.int64), n_out, mod)
    want = RSMP.uniform_mod_q_stream(words.astype(np.uint32), n_out,
                                     ref_params(name).mod)
    np.testing.assert_array_equal(got, np.asarray(want))
