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
    aes_ctr_kernel_apply,
    aes_xof_words,
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
