"""The port's sharded model (DTensor parameters and activations over a
``torch.distributed`` mesh: ``forward_train``, ``prefill``/``decode_step``
through the policy-taking serve steps, ``loss_fn`` and its gradients,
``moe_ffn_sharded``) against the JAX reference, on gloo worlds of 4 CPU
ranks (``tests/test_torch_world.py``; one world per task, started once per
module).

Smoke configs in float32 compute with float32 masters: granite-3-8b on
(1, 4) (tp_a 2 x tp_b 2), qwen2-vl-7b on (1, 4) (tp_a 2, sp 2),
mamba2-2.7b on (2, 2) (dp 2 x tp_a 2), mixtral-8x7b on (1, 4)
(expert-parallel, 2 experts a rank) and jamba-1.5-large on (1, 4).  Each
is held against the reference's unsharded results on the same weights
and inputs.  Tolerances:

* logits (forward, prefill, each teacher-forced decode step) and every
  gradient: within 1e-4 of the reference tensor's largest magnitude;
* loss, CE and aux: 1e-5 relative (aux: or 1e-7 absolute).

``moe_ffn_sharded`` at dp 2 (mixtral on (2, 2), with and without FSDP):
capacity is per data shard there, so it is held against the reference's
own ``moe_ffn_sharded`` under a matching 4-device mesh (computed in a
child process with 4 host devices): output within 1e-5 of its largest
magnitude, aux 1e-6 relative; and its gradients against the unsharded
``moe_ffn`` run on each data shard's tokens (the same function), within
1e-4 of each gradient's largest magnitude.  Serving with stationary
weights (features split over "data" too) routes all tokens together, so
it is held to ``moe_ffn`` on the whole batch the same way (the
reference's own output there is wrong at data 2: ROADMAP Queue 3).
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.models import model as RM  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_to_numpy  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_world import World, run_world  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CASES = {
    "granite-3-8b": ((1, 4), (2, 2, 1, 1)),
    "qwen2-vl-7b": ((1, 4), (2, 1, 2, 1)),
    "mamba2-2.7b": ((2, 2), (2, 1, 1, 2)),
    "mixtral-8x7b": ((1, 4), (2, 2, 1, 1)),
    "jamba-1.5-large": ((1, 4), (2, 2, 1, 1)),
}
B, T, N_DEC = 2, 16, 2
TOL = 1e-4


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "none":
        out["tokens"] = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    else:
        out["embeds"] = rng.normal(0, 1, (B, T, cfg.frontend_dim)).astype(
            np.float32)
        if cfg.rope_kind == "mrope":
            out["positions"] = np.broadcast_to(
                np.arange(T)[None, :, None], (B, T, 3)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    labels[0, -3:] = -1
    out["labels"] = labels
    return out


def _named(tree):
    return {"_".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(port's sharded results, reference's unsharded ones) per arch."""
    inputs, ref = {}, {}
    for i, (arch, (mesh, _)) in enumerate(CASES.items()):
        cfg = _f32(get_config(arch, smoke=True))
        tree = params_to_numpy(M.init_params(cfg, seed=10 + i, device="cpu"))
        batch = _batch(cfg, seed=20 + i)
        prompt = {k: v for k, v in batch.items() if k != "labels"}
        teacher = np.random.default_rng(30 + i).integers(
            0, cfg.vocab, (B, N_DEC)).astype(np.int32)
        inputs[arch] = {"mesh": mesh, "params": tree, "batch": batch,
                        "prompt": prompt, "teacher": teacher}
    # the world runs while the reference compiles
    world = World("model", 4, tmp_path_factory.mktemp("world_model"),
                  inputs, timeout=280)
    for arch, case in inputs.items():
        rcfg = _f32(ref_get_config(arch, smoke=True))
        tree, batch, prompt, teacher = (case[k] for k in (
            "params", "batch", "prompt", "teacher"))
        params = jax.tree.map(jnp.asarray, tree)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jp = {k: jnp.asarray(v) for k, v in prompt.items()}
        fwd = jax.jit(lambda p, b: RM.forward_train(rcfg, p, b)[0])(params, jp)
        (loss, (ce, aux)), g = jax.jit(jax.value_and_grad(
            lambda p: RM.loss_fn(rcfg, p, jb), has_aux=True))(params)
        logits, cache, cur = jax.jit(
            lambda p, b: RM.prefill(rcfg, p, b, T + N_DEC + 1))(params, jp)
        step = jax.jit(lambda p, c, t, n: RM.decode_step(rcfg, p, c, t, n))
        dec = []
        for j in range(N_DEC):
            cur = cur + 1
            lj, cache = step(params, cache, jnp.asarray(teacher[:, j:j + 1]),
                             cur)
            dec.append(np.asarray(lj))
        ref[arch] = {"forward": np.asarray(fwd), "prefill": np.asarray(logits),
                     "decode": dec, "grads": _named(g),
                     "loss": [float(loss), float(ce), float(aux)]}
    return world.result(), ref


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


@pytest.mark.parametrize("what", ["forward", "prefill", "decode", "loss",
                                  "grads"])
@pytest.mark.parametrize("arch", list(CASES))
def test_sharded_pass_matches_the_unsharded_reference(results, arch, what):
    got, ref = results[0][arch], results[1][arch]
    assert tuple(got["policy"]) == CASES[arch][1]
    if what in ("forward", "prefill"):
        _close(got[what], ref[what])
    elif what == "decode":
        assert len(got["decode"]) == N_DEC
        for a, b in zip(got["decode"], ref["decode"]):
            _close(a, b)
    elif what == "loss":
        (l, ce, aux), (rl, rce, raux) = got["loss"], ref["loss"]
        assert abs(l - rl) <= 1e-5 * abs(rl)
        assert abs(ce - rce) <= 1e-5 * abs(rce)
        assert abs(aux - raux) <= max(1e-5 * abs(raux), 1e-7)
    else:
        assert sorted(got["grads"]) == sorted(ref["grads"])
        for name, want in ref["grads"].items():
            g = got["grads"][name]
            g = np.zeros(want.shape, np.float32) if g is None else g
            _close(g, want)


# ---------------------------------------------------------------------------
# moe_ffn_sharded at dp 2
# ---------------------------------------------------------------------------
#: (memory budget, train): replicated weights, FSDP, stationary weights
MOE_VARIANTS = {"replicated": (16e9, True), "fsdp": (1.0, True),
                "weight_stationary": (1.0, False)}
#: the variants the reference's moe_ffn_sharded is held to; under
#: stationary weights it sums products of different data shards' tokens
#: (ROADMAP Queue 3), so the port is held to moe_ffn there
REF_VARIANTS = ("replicated", "fsdp")

_MOE_CHILD = textwrap.dedent("""
    import dataclasses, pickle, sys
    import jax, numpy as np
    import repro.models.sharding as S
    from repro.configs.base import get_config
    from repro.models.moe import moe_ffn_sharded

    with open(sys.argv[1], "rb") as f:
        inp = pickle.load(f)
    cfg = dataclasses.replace(get_config(inp["arch"], True),
                              dtype="float32", param_dtype="float32")
    mesh = jax.make_mesh(tuple(inp["mesh"]), ("data", "model"))
    args = [inp[k] for k in ("x", "router", "wi_g", "wi_u", "wo")]
    out = {}
    for name, (hbm, train) in inp["ref_variants"].items():
        S.HBM_PER_CHIP = hbm        # the policy's memory budget, this child only
        pol = S.make_policy(mesh, cfg, batch=args[0].shape[0], train=train)
        y, aux = jax.jit(lambda *a: moe_ffn_sharded(cfg, *a, pol))(*args)
        out[name] = {"y": np.asarray(y), "aux": float(aux), "fsdp": pol.fsdp}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


@pytest.fixture(scope="module")
def moe_results(tmp_path_factory):
    cfg = _f32(get_config("mixtral-8x7b", smoke=True))
    rng = np.random.default_rng(40)
    D, E, F_ = cfg.d_model, cfg.num_experts, cfg.d_ff
    inp = {"arch": "mixtral-8x7b", "mesh": (2, 2), "variants": MOE_VARIANTS,
           "ref_variants": {k: MOE_VARIANTS[k] for k in REF_VARIANTS},
           "x": rng.normal(0, 1, (4, 8, D)).astype(np.float32),
           "router": rng.normal(0, 0.5, (D, E)).astype(np.float32),
           "wi_g": rng.normal(0, 0.1, (E, D, F_)).astype(np.float32),
           "wi_u": rng.normal(0, 0.1, (E, D, F_)).astype(np.float32),
           "wo": rng.normal(0, 0.1, (E, F_, D)).astype(np.float32),
           "proj": rng.normal(0, 1, (4, 8, D)).astype(np.float32)}
    work = tmp_path_factory.mktemp("world_moe")
    with open(work / "ref_in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen(
        [sys.executable, "-c", _MOE_CHILD, str(work / "ref_in.pkl"),
         str(work / "ref_out.pkl")], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    got = run_world("moe", 4, work / "port", inp, timeout=200)
    _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    with open(work / "ref_out.pkl", "rb") as f:
        return got, pickle.load(f)


@pytest.mark.parametrize("variant", REF_VARIANTS)
def test_moe_sharded_at_dp2_matches_the_reference_moe_sharded(moe_results,
                                                              variant):
    got, ref = moe_results[0][variant], moe_results[1][variant]
    assert got["dp"] == 2
    assert got["fsdp"] == ref["fsdp"] == (variant == "fsdp")
    _close(got["y"], ref["y"], 1e-5)
    assert abs(got["aux"] - ref["aux"]) <= 1e-6 * abs(ref["aux"])


@pytest.mark.parametrize("variant", list(MOE_VARIANTS))
def test_moe_sharded_at_dp2_gradients_match_per_shard_moe(moe_results,
                                                          variant):
    got = moe_results[0][variant]
    assert got["ws"] == (variant == "weight_stationary")
    plain = got["plain"]
    _close(got["y"], plain["y"], 1e-5)
    assert abs(got["aux"] - plain["aux"]) <= 1e-6 * abs(plain["aux"])
    for g, want in zip(got["grads"], plain["grads"]):
        _close(g, want)
