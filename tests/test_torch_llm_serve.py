"""The port's LLM serving path (``repro_torch.launch.serve``,
``repro_torch.serve.serve_loop``) against the JAX reference on the CPU.

* ``EncryptedChannel``: the client's ciphertexts, the server-issued
  counters and the re-encrypted responses equal the reference's word for
  word for the same seed, through a forced session rotation;
* greedy decoding through ``serve_loop`` gives the reference's tokens in
  float32, on the reference's weights;
* ``main`` runs as a child process and in-process on ``--device cpu``,
  prints the reference's lines, and refuses to run without a card unless
  told ``--device cpu``.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.launch import serve as RS  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.sharding import make_policy  # noqa: E402
from repro.serve import serve_loop as RSL  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.cipher import SESSION_CTR_LIMIT  # noqa: E402
from repro_torch.launch import serve as PS  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.serve import serve_loop as PSL  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
# the lines the reference's main prints, in order (the sample's tokens and
# the times differ)
LINES = ("prompts arrived HHE-encrypted; decrypted through KeystreamFarm "
         "windows (", "prefill 2x16: ", "decoded 3 steps in ", "sample: ",
         "responses re-encrypted through the farm; round-trip verified "
         "client-side (2 lanes)", "HHE window latency: count=")


def _same_words(port_cts, ref_cts):
    assert len(port_cts) == len(ref_cts)
    for p, r in zip(port_cts, ref_cts):
        r = np.asarray(r)
        assert p.dtype == np.uint32 and p.shape == r.shape
        np.testing.assert_array_equal(p, r.astype(np.uint32))


@pytest.mark.parametrize("cipher", ["hera-128a", "rubato-128l"])
def test_encrypted_channel_words_equal_the_reference(cipher):
    rng = np.random.default_rng(21)
    lanes, T, T_gen = 3, 40, 7
    prompts = rng.integers(0, 49155, (lanes, T), dtype=np.int32)
    gen = rng.integers(0, 49155, (lanes, T_gen), dtype=np.int32)
    ref = RS.EncryptedChannel(cipher, lanes, seed=5)
    port = PS.EncryptedChannel(cipher, lanes, seed=5, device="cpu")
    np.testing.assert_array_equal(port.batch.key.numpy(),
                                  np.asarray(ref.batch.key))

    def turn():
        rc, pc = ref.client_encrypt(prompts), port.client_encrypt(prompts)
        _same_words(pc, rc)
        np.testing.assert_array_equal(port.serve_decrypt_prompts(pc, T),
                                      prompts)
        np.testing.assert_array_equal(
            np.asarray(ref.serve_decrypt_prompts(rc, T)), prompts)
        renc = ref.serve_encrypt_responses(gen)
        penc = port.serve_encrypt_responses(gen)
        _same_words([c for c, _ in penc], [c for c, _ in renc])
        for i, ((_, pctr), (_, rctr)) in enumerate(zip(penc, renc)):
            np.testing.assert_array_equal(pctr, np.asarray(rctr))
            back = port.client_decrypt(penc[i][0], pctr, i, T_gen)
            np.testing.assert_array_equal(back, gen[i])

    turn()
    # push lane 1 to the end of its counter space: the next prompt must
    # rotate that session before it is encrypted, on both sides alike
    for ch in (ref, port):
        ch.batch.sessions[1].next_ctr = SESSION_CTR_LIMIT - 1
    turn()
    s_port, s_ref = port.batch.sessions[1], ref.batch.sessions[1]
    assert s_port.generation == s_ref.generation == 1
    np.testing.assert_array_equal(s_port.nonce, np.asarray(s_ref.nonce))
    assert [s.next_ctr for s in port.batch.sessions] == \
        [s.next_ctr for s in ref.batch.sessions]
    assert port.latency_stats()["count"] == ref.latency_stats()["count"]


def test_latency_stats_before_traffic_have_the_reference_shape():
    port = PS.EncryptedChannel("hera-128a", 2, device="cpu")
    ref = RS.EncryptedChannel("hera-128a", 2)
    assert port.latency_stats() == ref.latency_stats()


def _loud_params(arch, seed):
    """Reference weights with every normal-initialised matrix scaled up,
    so that greedy decoding does not just repeat the last prompt token."""
    rcfg = ref_get_config(arch, True)
    tree = jax.tree.map(np.asarray, RM.init_params(rcfg, jax.random.key(seed)))
    for path, d in M.iter_defs(get_config(arch, True)):
        if d.init == "normal":
            node = tree
            for key in path[:-1]:
                node = node[key]
            node[path[-1]] = (np.asarray(node[path[-1]], np.float32)
                              * 40).astype(node[path[-1]].dtype)
    return tree


@pytest.mark.parametrize("arch", ["granite-3-8b", "jamba-1.5-large",
                                  "mamba2-2.7b", "mixtral-8x7b"])
def test_greedy_tokens_equal_the_reference_in_float32(arch):
    B, T, n_gen = 2, 16, 6
    cfg = dataclasses.replace(get_config(arch, True), dtype="float32")
    rcfg = dataclasses.replace(ref_get_config(arch, True), dtype="float32")
    tree = _loud_params(arch, seed=3)
    prompts = np.random.default_rng(22).integers(0, cfg.vocab, (B, T))

    mesh = make_host_mesh()
    policy = make_policy(mesh, rcfg, batch=B, train=False)
    rprefill = RSL.make_prefill_step(rcfg, policy, T + n_gen)
    rdecode = RSL.make_decode_step(rcfg, policy)
    rparams = jax.tree.map(jnp.asarray, tree)
    with mesh:
        logits, cache, cur = rprefill(
            rparams, {"tokens": jnp.asarray(prompts, jnp.int32)})
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        ref = [np.asarray(tok)]
        for _ in range(n_gen - 1):
            cur = cur + 1
            logits, cache = rdecode(rparams, cache, tok, cur)
            tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            ref.append(np.asarray(tok))
    ref = np.concatenate(ref, axis=1)

    model = params_from_reference(cfg, tree, device="cpu")
    prefill = PSL.make_prefill_step(cfg, T + n_gen, device="cpu")
    decode = PSL.make_decode_step(cfg, device="cpu")
    logits, cache, cur = prefill(model, {"tokens": prompts})
    tok = torch.argmax(logits[:, -1:], dim=-1)
    got = [tok]
    for _ in range(n_gen - 1):
        cur += 1
        logits, cache = decode(model, cache, tok, cur)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        got.append(tok)
    got = torch.cat(got, dim=1).numpy()

    np.testing.assert_array_equal(got, ref)
    # the weights steer the tokens: not the last prompt token repeated
    assert len(np.unique(got)) > B


def test_serve_loop_steps_check_the_parameters_device():
    cfg = get_config("granite-3-8b", True)
    model = M.init_params(cfg, device="cpu")
    step = PSL.make_prefill_step(cfg, 8, device="cpu")
    logits, cache, cur = step(model, {"tokens": np.zeros((1, 4), np.int64)})
    assert cur == 4 and logits.shape == (1, 1, cfg.vocab_padded)
    assert cache[0]["k"].shape == (cfg.num_groups, 1, 8, cfg.kv_heads,
                                   cfg.resolved_head_dim)
    elsewhere = PSL.make_decode_step(cfg, device="meta")
    with pytest.raises(ValueError, match="parameters on cpu"):
        elsewhere(model, cache, np.zeros((1, 1), np.int64), 5)


def _run_main(capsys, *extra):
    out = PS.main(["--arch", "granite-3-8b", "--smoke", "--batch", "2",
                   "--prompt-len", "16", "--gen", "4", "--device", "cpu",
                   *extra])
    return out, capsys.readouterr().out.splitlines()


def test_main_in_process_prints_the_reference_lines(capsys):
    out, lines = _run_main(capsys, "--encrypted", "--cipher", "hera-128a")
    assert len(lines) == len(LINES)
    for line, want in zip(lines, LINES):
        assert line.startswith(want), (line, want)
    assert "engine=ref" in lines[0] and "window=2" in lines[0]
    assert out["gen"].shape == (2, 4) and out["gen"].dtype == np.int32
    assert out["hhe"]["count"] == 4 and out["decode_steps"] == 3
    assert out["device"] == "cpu" and out["prefill_ms"] > 0
    plain, plain_lines = _run_main(capsys)
    np.testing.assert_array_equal(plain["gen"], out["gen"])
    assert plain["hhe"] is None
    assert len(plain_lines) == 3
    for line, want in zip(plain_lines, LINES[1:4]):
        assert line.startswith(want), (line, want)


def test_main_autotunes_then_serves_from_the_plan(capsys, tmp_path,
                                                  monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNER_CACHE", str(tmp_path / "none"))
    plans = tmp_path / "plans.json"
    tuned, lines = _run_main(capsys, "--encrypted", "--cipher", "hera-128a",
                             "--autotune", "--plan", str(plans))
    assert plans.exists()
    assert any(x.startswith("serving from measured StreamPlan: ")
               for x in lines)
    again, lines = _run_main(capsys, "--encrypted", "--cipher", "hera-128a",
                             "--plan", str(plans))
    assert lines[0].startswith("serving from measured StreamPlan: ")
    np.testing.assert_array_equal(again["gen"], tuned["gen"])
    with pytest.raises(SystemExit, match="no StreamPlan cached"):
        _run_main(capsys, "--encrypted", "--cipher", "rubato-128l",
                  "--plan", str(plans))


def test_main_refuses_what_it_does_not_serve(capsys):
    with pytest.raises(SystemExit, match="encoder-only"):
        PS.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit):         # argparse: not a flag here
        PS.main(["--arch", "granite-3-8b", "--smoke", "--device", "cpu",
                 "--production-mesh"])
    assert "--production-mesh" in capsys.readouterr().err


def test_main_without_a_card_names_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        PS.main(["--arch", "granite-3-8b", "--smoke"])


def test_cli_serves_encrypted_prompts_on_the_cpu():
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "granite-3-8b", "--smoke", "--batch", "2", "--prompt-len", "16",
           "--gen", "4", "--encrypted", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert len(lines) == len(LINES)
    for line, want in zip(lines, LINES):
        assert line.startswith(want), (line, want)
