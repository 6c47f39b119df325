"""The rest of the port's public surface against the JAX reference: the
stream-key wrappers, the round primitives, AES-CTR, the samplers,
`presto_keystream`, and the package exports (which must build no kernel
and import no JAX).  Inputs are numpy arrays from a seed, fed to both."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.core as ref_core_pkg  # noqa: E402
import repro.crypto as ref_crypto_pkg  # noqa: E402
import repro.kernels as ref_kernels_pkg  # noqa: E402
from repro.core import rounds as ref_rounds  # noqa: E402
from repro.core.cipher import make_cipher as ref_make_cipher  # noqa: E402
from repro.core.hera import hera_stream_key as ref_hera  # noqa: E402
from repro.core.params import get_params as ref_get_params  # noqa: E402
from repro.core.pasta import pasta_stream_key as ref_pasta  # noqa: E402
from repro.core.rubato import rubato_stream_key as ref_rubato  # noqa: E402
from repro.crypto import aes as ref_aes  # noqa: E402
from repro.crypto import sampler as ref_sampler  # noqa: E402
from repro.kernels.keystream.ops import (  # noqa: E402
    presto_keystream as ref_presto,
)

import repro_torch.core as core_pkg  # noqa: E402
import repro_torch.crypto as crypto_pkg  # noqa: E402
import repro_torch.kernels as kernels_pkg  # noqa: E402
from repro_torch.core import rounds  # noqa: E402
from repro_torch.core.cipher import make_cipher  # noqa: E402
from repro_torch.core.hera import hera_stream_key  # noqa: E402
from repro_torch.core.params import get_params  # noqa: E402
from repro_torch.core.pasta import pasta_stream_key  # noqa: E402
from repro_torch.core.rubato import rubato_stream_key  # noqa: E402
from repro_torch.crypto import aes, sampler  # noqa: E402
from repro_torch.kernels.keystream.ops import presto_keystream  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
KINDS = ["hera-128a", "rubato-128l", "pasta-128l"]
VARIANTS = ["normal", "alternating"]


def _i64(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


def _words(name, shape, seed):
    q = get_params(name).mod.q
    return np.random.default_rng(seed).integers(0, q, shape,
                                                dtype=np.uint32)


# ---------------------------------------------------------------------------
# the stream-key wrappers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", VARIANTS)
def test_hera_stream_key_matches_reference(variant):
    p = get_params("hera-128a")
    key = _words(p.name, (p.n,), 1)
    rc = _words(p.name, (3, p.n_arks, p.n), 2)
    got = hera_stream_key(p, _i64(key), _i64(rc), variant=variant)
    want = ref_hera(ref_get_params(p.name), jnp.asarray(key),
                    jnp.asarray(rc), variant=variant)
    _same(got, want)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("with_noise", [False, True])
def test_rubato_stream_key_matches_reference(variant, with_noise):
    p = get_params("rubato-128s")
    key = _words(p.name, (p.n,), 3)
    rc = _words(p.name, (3, p.n_round_constants), 4)
    noise = np.random.default_rng(5).integers(-16, 17, (3, p.l)) \
        .astype(np.int32) if with_noise else None
    got = rubato_stream_key(p, _i64(key), _i64(rc),
                            None if noise is None else _i64(noise),
                            variant=variant)
    want = ref_rubato(ref_get_params(p.name), jnp.asarray(key),
                      jnp.asarray(rc),
                      None if noise is None else jnp.asarray(noise),
                      variant=variant)
    _same(got, want)


@pytest.mark.parametrize("variant", VARIANTS)
def test_pasta_stream_key_matches_reference(variant):
    p = get_params("pasta-128s")
    key = _words(p.name, (p.n,), 6)
    rc = _words(p.name, (2, p.n_round_constants), 7)
    mats = _words(p.name, (2, p.n_matrix_constants), 8)
    got = pasta_stream_key(p, _i64(key), _i64(rc), _i64(mats),
                           variant=variant)
    want = ref_pasta(ref_get_params(p.name), jnp.asarray(key),
                     jnp.asarray(rc), jnp.asarray(mats), variant=variant)
    _same(got, want)


@pytest.mark.parametrize("name,call", [
    ("hera-128a", lambda f, p, k, rc: f(p, k, rc)),
    ("rubato-128s", lambda f, p, k, rc: f(p, k, rc, None)),
    ("pasta-128s", lambda f, p, k, rc: f(p, k, rc)),
])
def test_stream_key_shape_errors_match_reference(name, call):
    port_fn = {"hera": hera_stream_key, "rubato": rubato_stream_key,
               "pasta": pasta_stream_key}
    ref_fn = {"hera": ref_hera, "rubato": ref_rubato, "pasta": ref_pasta}
    p = get_params(name)
    rc = np.zeros((2, p.n_round_constants + 1), np.uint32)
    key = np.zeros(p.n, np.uint32)
    with pytest.raises(ValueError) as want:
        call(ref_fn[p.kind], ref_get_params(name), jnp.asarray(key),
             jnp.asarray(rc))
    with pytest.raises(ValueError) as got:
        call(port_fn[p.kind], p, _i64(key), _i64(rc))
    assert str(got.value).replace("torch.Size([", "(").replace("])", ")") \
        == str(want.value)


def test_hera_stream_key_takes_an_initial_state():
    p = get_params("hera-128a")
    key = _words(p.name, (p.n,), 9)
    rc = _words(p.name, (2, p.n_arks, p.n), 10)
    ic = _words(p.name, (p.n,), 11)
    got = hera_stream_key(p, _i64(key), _i64(rc), ic=_i64(ic))
    want = ref_hera(ref_get_params(p.name), jnp.asarray(key),
                    jnp.asarray(rc), ic=jnp.asarray(ic))
    _same(got, want)


# ---------------------------------------------------------------------------
# round primitives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", KINDS)
@pytest.mark.parametrize("fn", ["mix_columns", "mix_rows", "mrmc",
                                "mrmc_transposed"])
def test_matrix_primitives_match_reference(name, fn):
    p = get_params(name)
    x = _words(name, (5, p.n), 12)
    got = getattr(rounds, fn)(p, _i64(x))
    want = getattr(ref_rounds, fn)(ref_get_params(name), jnp.asarray(x))
    _same(got, want)


@pytest.mark.parametrize("name", KINDS)
def test_mrmc_transposed_is_mrmc_of_the_transpose(name):
    p = get_params(name)
    x = _i64(_words(name, (3, p.n), 13))
    b, v = p.branches, p.v
    xt = x.reshape(3, b, v, v).transpose(-1, -2).reshape(3, p.n)
    back = rounds.mrmc_transposed(p, xt).reshape(3, b, v, v) \
        .transpose(-1, -2).reshape(3, p.n)
    assert torch.equal(back, rounds.mrmc(p, x))


@pytest.mark.parametrize("name", ["rubato-128l", "pasta-128l"])
@pytest.mark.parametrize("bound", [None, "q", "2q", "3q"])
def test_feistel_in_bound_matches_reference(name, bound):
    p = get_params(name)
    q = p.mod.q
    in_bound = None if bound is None else {"q": q, "2q": 2 * q,
                                           "3q": 3 * q}[bound]
    if in_bound is not None:
        assert p.mod.mul_fits(in_bound, in_bound)
    hi = q if in_bound is None else in_bound
    x = np.random.default_rng(14).integers(0, hi, (4, p.n),
                                           dtype=np.uint32)
    got = rounds.feistel(p, _i64(x), in_bound=in_bound)
    want = ref_rounds.feistel(ref_get_params(name), jnp.asarray(x),
                              in_bound=in_bound)
    _same(got, want)


# ---------------------------------------------------------------------------
# AES
# ---------------------------------------------------------------------------
def test_aes_tables_match_reference():
    assert aes.SBOX.dtype == torch.uint8
    np.testing.assert_array_equal(aes.SBOX.numpy(), np.asarray(ref_aes.SBOX))
    np.testing.assert_array_equal(aes.SHIFTROWS_PERM.numpy(),
                                  np.asarray(ref_aes.SHIFTROWS_PERM))


@pytest.mark.parametrize("counter0,nblocks", [(0, 1), (7, 33),
                                              (2**32 - 5, 9)])
def test_aes_ctr_keystream_matches_reference(counter0, nblocks):
    rng = np.random.default_rng(counter0 % 1000)
    rk = aes.aes128_key_expand(rng.integers(0, 256, 16, dtype=np.uint8))
    nonce = rng.integers(0, 256, 12, dtype=np.uint8)
    got = aes.aes_ctr_keystream(rk, nonce, counter0, nblocks, device="cpu")
    want = ref_aes.aes_ctr_keystream(rk, nonce, counter0, nblocks)
    assert got.dtype == torch.uint8 and got.shape == (nblocks, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_aes_ctr_keystream_fips197():
    rk = aes.aes128_key_expand(np.arange(16, dtype=np.uint8))
    nonce = np.array(list(bytes.fromhex("00112233445566778899aabb")),
                     np.uint8)
    out = aes.aes_ctr_keystream(rk, nonce, 0xCCDDEEFF, 1, device="cpu")
    assert bytes(out.numpy()[0]).hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", KINDS)
def test_uniform_mod_q_matches_reference(name):
    p = get_params(name)
    rng = np.random.default_rng(15)
    words = rng.integers(0, 2**32, (6, 9, sampler.OVERDRAW),
                         dtype=np.uint32)
    # candidates that the mask leaves at or above q: first, middle, all
    top = np.uint32((1 << p.mod.bits) - 1)
    words[0, :, 0] = top
    words[1, :, :2] = top
    words[2, 0, :] = top
    got = sampler.uniform_mod_q(_i64(words), p.mod)
    want = ref_sampler.uniform_mod_q(jnp.asarray(words),
                                     ref_get_params(name).mod)
    _same(got, want)
    with pytest.raises(ValueError, match="overdraw"):
        sampler.uniform_mod_q(_i64(words[..., :3]), p.mod)


def test_sampler_constants_match_reference():
    assert sampler.OVERDRAW == ref_sampler.OVERDRAW
    for n in (0, 1, 16, 188, 512):
        assert sampler.words_needed_uniform(n) \
            == ref_sampler.words_needed_uniform(n)
        assert sampler.words_needed_gauss(n) \
            == ref_sampler.words_needed_gauss(n)


# ---------------------------------------------------------------------------
# presto_keystream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["hera-128a", "rubato-128s"])
def test_presto_keystream_matches_reference(name):
    """The reference's producer -> Pallas kernel (interpret mode) on 4
    counters, against the port's producer -> fused consumer on the CPU."""
    ctrs = np.arange(4)
    want = ref_presto(ref_make_cipher(name, seed=2),
                      jnp.asarray(ctrs, jnp.uint32), interpret=True)
    ci = make_cipher(name, seed=2, device="cpu")
    got = presto_keystream(ci, ctrs)
    _same(got, want)
    assert torch.equal(got, ci.keystream(ctrs))


# ---------------------------------------------------------------------------
# package exports
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ref_pkg,port_pkg", [
    (ref_core_pkg, core_pkg),
    (ref_crypto_pkg, crypto_pkg),
    (ref_kernels_pkg, kernels_pkg),
], ids=["core", "crypto", "kernels"])
def test_exports_cover_the_reference(ref_pkg, port_pkg):
    assert set(ref_pkg.__all__) <= set(port_pkg.__all__)
    for name in port_pkg.__all__:
        assert getattr(port_pkg, name) is not None, name


def test_importing_the_packages_builds_nothing_and_imports_no_jax():
    code = ("import sys, torch\n"
            "import repro_torch.kernels, repro_torch.core, "
            "repro_torch.crypto\n"
            "from repro_torch.kernels import build\n"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro'\n"
            "       or m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n"
            "assert build._lib is None, 'a kernel library was loaded'\n"
            "assert not torch.cuda.is_initialized(), 'CUDA was touched'\n"
            "assert sum(build.LAUNCHES.values()) == 0\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# the port's examples
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("script,args", [
    ("torch_quickstart.py", ["--device", "cpu"]),
    ("torch_keystream_farm.py", ["--device", "cpu", "--lanes", "64"]),
])
def test_example_runs_on_the_cpu(script, args, tmp_path):
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), *args],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env=dict(os.environ, REPRO_TORCH_TUNER_CACHE=str(
            tmp_path / "plans.json"), OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "FAILED" not in out.stdout
    assert "jax" not in out.stderr
