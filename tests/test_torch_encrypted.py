"""The port's encrypted data source (`repro_torch.data.encrypted`) against
the JAX package's on the reference's own `SyntheticLM` (batch 2, seq 16):
`encrypt_tokens`, `make_decryptor`, `EncryptedSource` and
`FarmEncryptedSource` (random access, the pipelined stream, and with a
plan), word for word."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs.base import get_config  # noqa: E402
from repro.core.cipher import CipherBatch as RefBatch  # noqa: E402
from repro.core.cipher import make_cipher as ref_make_cipher  # noqa: E402
from repro.core.tuner import StreamPlan as RefPlan  # noqa: E402
from repro.data import encrypted as RE  # noqa: E402
from repro.data.pipeline import SyntheticLM  # noqa: E402

from repro_torch.core.cipher import make_cipher  # noqa: E402
from repro_torch.core.convert import batch_from_reference  # noqa: E402
from repro_torch.core.tuner import StreamPlan  # noqa: E402
from repro_torch.data import encrypted as E  # noqa: E402

PRESETS = ["hera-128a", "rubato-128l", "pasta-128s"]


@pytest.fixture(scope="module")
def source():
    return SyntheticLM(get_config("deepseek-7b", smoke=True), batch=2,
                       seq_len=16, seed=0)


def _same(got: dict, want: dict):
    np.testing.assert_array_equal(got["ct"].numpy(),
                                  np.asarray(want["ct"]).astype(np.int64))
    assert got["ct"].dtype == torch.int64 and got["base_ctr"].dtype == \
        torch.int64 and got["base_ctr"].dim() == 0
    assert int(got["base_ctr"]) == int(want["base_ctr"])


@pytest.mark.parametrize("name", PRESETS)
def test_encrypt_tokens_and_decryptor_match_reference(name, source):
    ci = make_cipher(name, seed=4, device="cpu")
    ref = ref_make_cipher(name, seed=4)
    toks = source.batch_at(1)["tokens"]
    enc = E.encrypt_tokens(ci, toks, 40)
    renc = RE.encrypt_tokens(ref, toks, 40)
    _same(enc, renc)
    for labels in (True, False):
        out = E.make_decryptor(ci, labels_from_tokens=labels)(enc)
        rout = RE.make_decryptor(ref, labels_from_tokens=labels)(renc)
        assert sorted(out) == sorted(rout)
        for k in out:
            assert out[k].dtype == torch.int32
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(rout[k]))
        np.testing.assert_array_equal(out["tokens"].numpy(), toks)


def test_encrypted_source_matches_reference(source):
    ci = make_cipher("rubato-128l", seed=6, device="cpu")
    ref = ref_make_cipher("rubato-128l", seed=6)
    es, res = E.EncryptedSource(source, ci), RE.EncryptedSource(source, ref)
    assert es.blocks_per_batch() == res.blocks_per_batch()
    for step in range(3):
        _same(es.batch_at(step), res.batch_at(step))


def _pair(name, seed):
    ref = RefBatch(name, seed=seed, engine="ref")
    port = batch_from_reference(name, np.asarray(ref.key),
                                np.zeros((0, 16), np.uint8), device="cpu")
    port._rng.bit_generator.state = ref._rng.bit_generator.state
    return ref, port


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("plan", [None, StreamPlan("cached", "ref",
                                                   "alternating", 4, 3)])
def test_farm_source_matches_reference(name, plan, source):
    ref, port = _pair(name, seed=21)
    rplan = None if plan is None else RefPlan.from_json(
        dict(plan.to_json(), engine="jax"))
    fsrc = E.FarmEncryptedSource(source, port, plan=plan)
    rsrc = RE.FarmEncryptedSource(source, ref, engine=None if plan else "ref",
                                  plan=rplan)
    assert np.array_equal(fsrc.session.nonce, rsrc.session.nonce)
    assert fsrc.blocks_per_batch() == rsrc.blocks_per_batch()
    if plan is not None:
        assert port.producer.name == "cached" and fsrc.farm.depth == 3
    for step in (0, 3):
        got = fsrc.batch_at(step)
        _same(got, rsrc.batch_at(step))
        _same(got, E.encrypt_tokens(fsrc.cipher,
                                    source.batch_at(step)["tokens"],
                                    step * fsrc.blocks_per_batch()))
    dec = E.make_decryptor(fsrc.cipher)
    streamed = list(fsrc.stream(start_step=1, n_steps=3))
    rstreamed = list(rsrc.stream(start_step=1, n_steps=3))
    assert len(streamed) == len(rstreamed) == 3
    for step, (got, want) in enumerate(zip(streamed, rstreamed), 1):
        _same(got, want)
        np.testing.assert_array_equal(dec(got)["tokens"].numpy(),
                                      source.batch_at(step)["tokens"])


def test_farm_source_shares_a_pool_across_sessions(source):
    _, port = _pair("hera-128a", seed=3)
    a = E.FarmEncryptedSource(source, port)
    b = E.FarmEncryptedSource(source, port)
    assert (a.session.index, b.session.index) == (0, 1)
    za, zb = a.batch_at(0)["ct"], b.batch_at(0)["ct"]
    assert not torch.equal(za, zb)
    np.testing.assert_array_equal(
        E.make_decryptor(b.cipher)(b.batch_at(0))["tokens"].numpy(),
        source.batch_at(0)["tokens"])
