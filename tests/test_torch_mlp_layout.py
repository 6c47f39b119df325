"""The sharded dense MLP's layout (`repro_torch.models.layers.
mlp_shardings`): under a policy the hidden (B, T, F) and its gradient are
laid out as the activations with F over the model axes ("mlp_h"), and the
output's gradient with D whole ("mlp_out"), so that DTensor's plan of the
MLP, and the dry run's counts, do not depend on torch's version.

Children, started together (module fixture), each with its own timeout:

- (a) qwen2-vl-7b at smoke size with 12 query and 4 KV heads, so that a
  "model" axis of 16 refines as the 2-pod train_4k cell's does (tp_a 4,
  tp_b 1, sp 4), traced through the train step on a fake (pod 2, data 2,
  model 16) world: it runs, and every product of the MLP (forward and
  backward) runs on F/16 of its features;
- (b) arctic-480b at smoke size with 8 query and 8 KV heads and 16
  experts, so that its prefill policy on a fake (data 2, model 16) world
  splits "model" as the 1-pod prefill_32k cell's does (tp_a 8, sp 2,
  stationary weights): the dense residual's down projection counts its
  rank's share, the unsharded product over the 32 ranks; and (d) on the
  same world, the dense MLP's constraints hand the hidden its gradient
  laid out by "mlp_h" and the output's by "mlp_out";
- (c) a gloo world of 4 CPU ranks (as ``tests/test_torch_world.py``
  starts them): the sharded dense MLP's output and its weights'
  gradients equal the unsharded MLP's within 1e-4 of their largest
  magnitude (``tests/test_torch_sharded_model.py``'s tolerance), on the
  one-shot and the F-chunked paths (``CHUNK_MIN_ELEMS`` and
  ``CHUNK_MIN_TOKENS`` lowered in the ranks), with the gated, GELU,
  FSDP-free, data-parallel and stationary-weight policies; and (d) the
  gradients there arrive laid out as in (b), one a chunk, and each
  F-chunk's weights' gradients with F over the model axes and D whole.

Neither smoke world reproduces what torch 2.11 did at full width
(qwen2-vl-7b's 2-pod train step raised in its backward; PERF.md §6):
``chip_smoke.py`` phase 14 traces that cell's split at full width on the
card's torch.  (a) takes minutes on one CPU core: torch 2.13's DTensor
plans each op on a mesh of four dims in seconds.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.models.sharding import make_policy as ref_make_policy  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.sharding import P, make_policy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
#: (a)'s variant: F = 176 so that F/16 = 11 and F/8, F/4, F/2, F name no
#: other dim of the step
QWEN = dict(num_heads=12, kv_heads=4, head_dim=8, mrope_sections=(2, 1, 1),
            d_ff=176)
#: (b)'s variant: F = 224, so F/16 = 14 (the hidden's share) and F/32 = 7
#: (the stationary weights' split)
ARCTIC = dict(num_heads=8, kv_heads=8, num_experts=16, d_ff=224)
#: (c): (arch, mesh, train policy, hbm bytes, chunked path)
WORLD_CASES = {
    "qwen2-vl-1x4": ("qwen2-vl-7b", (1, 4), True, 16e9, False),
    "qwen2-vl-1x4-chunked": ("qwen2-vl-7b", (1, 4), True, 16e9, True),
    "granite-2x2": ("granite-3-8b", (2, 2), True, 16e9, False),
    "granite-2x2-chunked": ("granite-3-8b", (2, 2), True, 16e9, True),
    "granite-2x2-stationary": ("granite-3-8b", (2, 2), False, 1.0, False),
    "hubert-1x4-gelu": ("hubert-xlarge", (1, 4), True, 16e9, False),
}
CHILD_TIMEOUT = {"qwen": 480, "arctic": 120, "world": 120}

_PRELUDE = textwrap.dedent("""
    import dataclasses, json, pickle, sys
    import numpy as np
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs.base import LayerSpec, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.train.train_loop import act_shardings

    def constrained_grads(y, inputs, dy):
        # the gradients the layout constraints of y's graph hand back
        # (their dims, last dim and placements), and the inputs' gradients
        seen, todo, got = set(), [y.grad_fn], []
        while todo:
            node = todo.pop()
            if node is None or node in seen:
                continue
            seen.add(node)
            if type(node).__name__ == "ConstrainedBackward":
                node.register_hook(lambda gi, go: got.append(
                    [gi[0].ndim, gi[0].shape[-1],
                     [repr(p) for p in gi[0].placements]]))
            todo += [n for n, _ in node.next_functions]
        grads = torch.autograd.grad(y, inputs, grad_outputs=dy)
        return grads, got

    def layouts(pol, acts):
        # the placements of "mlp_h", "mlp_out", "mlp_wi" and "mlp_wo"
        spec, tp = tuple(acts["acts"]), pol.tp_full
        return {k: [repr(p) for p in pol.placements(s)] for k, s in (
            ("mlp_h", spec), ("mlp_out", spec[:-1] + (None,)),
            ("mlp_wi", (None, tp)), ("mlp_wo", (tp, None)))}
""")

_QWEN = _PRELUDE + textwrap.dedent("""
    cfg = dataclasses.replace(get_config("qwen2-vl-7b", smoke=True),
                              **json.loads(sys.argv[1]))
    D.start_fake_world(64)
    mesh = make_mesh((2, 2, 16), ("pod", "data", "model"), device="cpu")
    shape = D.C.Shape("train_smoke", 32, 32, "train")
    pol = D.cell_policy(cfg, shape, mesh, 16e9)
    rec = {"tp": [pol.tp_a, pol.tp_b, pol.sp], "fsdp": pol.fsdp}
    rec.update(D.trace_step(cfg, shape, pol, torch.device("cpu")))
    print(json.dumps(rec))
""")

_ARCTIC = _PRELUDE + textwrap.dedent("""
    cfg = dataclasses.replace(get_config("arctic-480b", smoke=True),
                              **json.loads(sys.argv[1]))
    D.start_fake_world(32)
    mesh = make_mesh((2, 16), ("data", "model"), device="cpu")
    shape = D.C.Shape("prefill_smoke", 64, 4, "prefill")
    pol = D.cell_policy(cfg, shape, mesh, 1.0)
    dev = torch.device("cpu")
    out = {"tp": [pol.tp_a, pol.tp_b, pol.sp], "fsdp": pol.fsdp,
           "stationary": pol.weight_stationary,
           "rank": D.trace_step(cfg, shape, pol, dev)["flops_by_op"],
           "whole": D.trace_step(cfg, shape, None, dev)["flops_by_op"]}

    # (d): the dense MLP alone, forward and backward, on this policy
    acts = act_shardings(cfg, pol)
    B, T, Dm, F = 4, 64, cfg.d_model, cfg.d_ff
    from repro_torch.models.layers import dtype_of, pdtype_of
    with FakeTensorMode():
        from torch.distributed.tensor import empty
        def leaf(shape, spec, dtype, grad=True):
            return empty(*shape, device_mesh=pol.mesh, requires_grad=grad,
                         dtype=dtype, placements=pol.placements(spec))
        rows = tuple(acts["acts"][:-1]) + (None,)
        x = leaf((B, T, Dm), rows, dtype_of(cfg))
        p = {"wi_g": leaf((Dm, F), pol.spec("wi", cfg), pdtype_of(cfg)),
             "wi_u": leaf((Dm, F), pol.spec("wi", cfg), pdtype_of(cfg)),
             "wo_m": leaf((F, Dm), pol.spec("wo_mlp", cfg), pdtype_of(cfg))}
        dy = leaf((B, T, Dm), acts["acts"], dtype_of(cfg), grad=False)
        with M.sharded_context(acts):
            y, _ = M._ffn_apply(cfg, LayerSpec(), p, x, shardings=acts)
            _, got = constrained_grads(y, list(p.values()), dy)
    out["constrained"] = got
    out.update(layouts(pol, acts))
    print(json.dumps(out))
""")

_WORLD = _PRELUDE + textwrap.dedent("""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.models import layers as L
    from repro_torch.models.sharding import make_policy

    workdir, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    init_distributed("cpu", store=dist.FileStore(workdir + "/store", world),
                     rank=rank, world_size=world, verbose=False)
    with open(workdir + "/inputs.pkl", "rb") as f:
        cases = pickle.load(f)
    thresholds = (L.CHUNK_MIN_ELEMS, L.CHUNK_MIN_TOKENS)
    B, T = 4, 16
    out = {}
    for i, (name, (arch, mesh_shape, train, hbm, chunked)) in enumerate(
            sorted(cases.items())):
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32", param_dtype="float32")
        # the chunked path from the smallest FFN on
        L.CHUNK_MIN_ELEMS, L.CHUNK_MIN_TOKENS = (0, 0) if chunked \\
            else thresholds
        mesh = make_mesh(tuple(mesh_shape), ("data", "model"), device="cpu")
        pol = make_policy(mesh, cfg, batch=B, train=train, hbm_bytes=hbm)
        acts = act_shardings(cfg, pol)
        rng = np.random.default_rng(40 + i)
        Dm, F = cfg.d_model, cfg.d_ff
        x = rng.normal(0, 1, (B, T, Dm)).astype(np.float32)
        w = {"wi_g": rng.normal(0, 0.1, (Dm, F)),
             "wi_u": rng.normal(0, 0.1, (Dm, F)),
             "wo_m": rng.normal(0, 0.1, (F, Dm))}
        if not cfg.mlp_gated:
            del w["wi_g"]
        dy = rng.normal(0, 1, (B, T, Dm)).astype(np.float32)
        roles = {"wi_g": "wi", "wi_u": "wi", "wo_m": "wo_mlp"}

        p = {k: torch.tensor(v, dtype=torch.float32, requires_grad=True)
             for k, v in w.items()}
        y0, _ = M._ffn_apply(cfg, LayerSpec(), p, torch.tensor(x))
        g0 = torch.autograd.grad(y0, list(p.values()),
                                 grad_outputs=torch.tensor(dy))

        rows = tuple(acts["acts"][:-1]) + (None,)
        pd = {k: M.place(v.detach(), pol, pol.spec(roles[k], cfg),
                         src_data_rank=None).requires_grad_()
              for k, v in p.items()}
        xd = M.place(torch.tensor(x), pol, rows, src_data_rank=None)
        dyd = M.place(torch.tensor(dy), pol, acts["acts"], src_data_rank=None)
        with M.sharded_context(acts):
            y, _ = M._ffn_apply(cfg, LayerSpec(), pd, xd, shardings=acts)
            g, got = constrained_grads(y, list(pd.values()), dyd)
        out[name] = {
            "policy": [pol.tp_a, pol.tp_b, pol.sp, pol.dp_size,
                       pol.weight_stationary],
            "y": (y.full_tensor().detach().numpy(), y0.detach().numpy()),
            "grads": {k: (a.full_tensor().numpy(), b.numpy())
                      for k, a, b in zip(p, g, g0)},
            "constrained": got, "d_ff": F, "d_model": Dm,
            **layouts(pol, acts)}
    if rank == 0:
        with open(workdir + "/result.pkl", "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
""")


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "XLA_FLAGS"):
        env.pop(k, None)
    return env


def _start(log, script, *args):
    return subprocess.Popen(
        [sys.executable, "-c", script, *map(str, args)], env=_env(),
        stdout=log, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Every child of this module, started at once, each writing to a log
    of its own (a pipe left unread would stall a child that fills it)."""
    work = tmp_path_factory.mktemp("mlp_world")
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(WORLD_CASES, f)
    logs = {n: open(work / f"{n}.log", "w+")
            for n in ("qwen", "arctic", "rank0", "rank1", "rank2", "rank3")}
    procs = {"qwen": [_start(logs["qwen"], _QWEN, json.dumps(QWEN))],
             "arctic": [_start(logs["arctic"], _ARCTIC, json.dumps(ARCTIC))],
             "world": [_start(logs[f"rank{r}"], _WORLD, work, r, 4)
                       for r in range(4)]}
    t0 = time.time()
    try:
        yield {"procs": procs, "t0": t0, "work": work, "logs": logs,
               "done": {}}
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                p.wait()
        for f in logs.values():
            f.close()


def _result(children, name):
    done = children["done"]
    if name in done:
        return done[name]
    procs = children["procs"][name]
    deadline = children["t0"] + CHILD_TIMEOUT[name]
    while any(p.poll() is None for p in procs) and time.time() < deadline \
            and not any(p.poll() not in (None, 0) for p in procs):
        time.sleep(0.1)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    names = [f"rank{r}" for r in range(4)] if name == "world" else [name]
    tails = []
    for n, p in zip(names, procs):
        f = children["logs"][n]
        f.seek(0)
        tails.append((p.returncode, f.read()))
    assert all(rc == 0 for rc, _ in tails), "\n".join(
        f"--- {n} (rc {rc}):\n{out[-3000:]}"
        for n, (rc, out) in zip(names, tails))
    if name == "world":
        with open(children["work"] / "result.pkl", "rb") as f:
            done[name] = pickle.load(f)
    else:
        done[name] = json.loads(tails[0][1].strip().splitlines()[-1])
    return done[name]


def _dims(op: str) -> list:
    """The operand dims of a ``flops_by_op`` key (``"bmm 1x64x96 @
    1x96x11"``)."""
    return [int(d) for t in op.split(" ", 1)[1].split(" @ ")
            for d in t.split("x")]


# ---------------------------------------------------------------------------
# (a) qwen2-vl-7b's 2-pod train split at smoke size
# ---------------------------------------------------------------------------
def test_qwen2_vl_two_pod_train_step_runs_the_mlp_on_its_share(children):
    rec = _result(children, "qwen")
    assert rec["tp"] == [4, 1, 4] and not rec["fsdp"]
    F = QWEN["d_ff"]
    D = get_config("qwen2-vl-7b", smoke=True).d_model
    layers = get_config("qwen2-vl-7b", smoke=True).num_layers
    ops = rec["flops_by_op"]
    assert not [op for op in ops
                if {F, F // 2, F // 4, F // 8} & set(_dims(op))], ops
    # 2 rows a rank a microbatch x 32 tokens; the forward's three
    # products and the backward's six, each 2·N·D·F/16, in 4 microbatches
    n = 2 * 32
    mlp = sum(v for op, v in ops.items() if F // 16 in _dims(op))
    assert mlp == 9 * 2 * n * D * (F // 16) * layers * 4


# ---------------------------------------------------------------------------
# (b), (d) arctic-480b's stationary-weight prefill split at smoke size
# ---------------------------------------------------------------------------
def test_arctic_dense_residual_down_projection_counts_its_share(children):
    rec = _result(children, "arctic")
    assert rec["tp"] == [8, 1, 2] and rec["stationary"] and not rec["fsdp"]
    cfg = get_config("arctic-480b", smoke=True)
    D, F, n = cfg.d_model, ARCTIC["d_ff"], 4 * 64
    whole = rec["whole"][f"bmm 1x{n}x{F} @ 1x{F}x{D}"]
    # tokens over "data" (2), the hidden's F over the model axes (16)
    share = rec["rank"].get(f"bmm 1x{n // 2}x{F // 16} @ 1x{F // 16}x{D}")
    assert share == whole / 32, sorted(rec["rank"])


def _check_constrained(got, F, D, chunks):
    """A gradient a chunk handed back to the hidden in "mlp_h"'s layout,
    one of the output's in "mlp_out"'s, and (F-chunked) three of the
    weight chunks' in "mlp_wi"'s and "mlp_wo"'s."""
    def grads(ndim, last):
        return [pl for n, d, pl in got["constrained"]
                if n == ndim and d == last]

    c = F // chunks
    want = {"mlp_h": (grads(3, c), chunks), "mlp_out": (grads(3, D), chunks),
            "mlp_wi": (grads(2, c), 2 * chunks if chunks > 1 else 0),
            "mlp_wo": (grads(2, D), chunks if chunks > 1 else 0)}
    for name, (pls, n) in want.items():
        assert len(pls) == n, (name, got["constrained"])
        assert all(pl == got[name] for pl in pls), (name, pls, got[name])


def test_arctic_hidden_gradient_arrives_laid_out_by_the_spec(children):
    rec = _result(children, "arctic")
    _check_constrained(rec, ARCTIC["d_ff"],
                       get_config("arctic-480b", smoke=True).d_model, 1)


# ---------------------------------------------------------------------------
# (c), (d) the gloo world
# ---------------------------------------------------------------------------
def _close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= TOL * float(np.abs(want).max()), err


@pytest.mark.parametrize("case", list(WORLD_CASES))
def test_sharded_mlp_matches_the_unsharded_one(children, case):
    got = _result(children, "world")[case]
    arch, mesh, train, _, _ = WORLD_CASES[case]
    assert got["policy"][3] == mesh[0] and got["policy"][4] == (not train)
    _close(*got["y"])
    want = {"wi_u", "wo_m"} | ({"wi_g"} if get_config(
        arch, smoke=True).mlp_gated else set())
    assert set(got["grads"]) == want
    for name, (a, b) in got["grads"].items():
        _close(a, b)


@pytest.mark.parametrize("case", list(WORLD_CASES))
def test_hidden_gradient_arrives_laid_out_by_the_spec(children, case):
    got = _result(children, "world")[case]
    _check_constrained(got, got["d_ff"], got["d_model"],
                       4 if WORLD_CASES[case][4] else 1)


# ---------------------------------------------------------------------------
# in-process
# ---------------------------------------------------------------------------
def test_a_chunk_that_does_not_split_over_the_model_axes_raises():
    cfg = get_config("granite-3-8b", smoke=True)
    pol = make_policy({"data": 1, "model": 4}, cfg, batch=2, train=True,
                      hbm_bytes=16e9)
    acts = {"acts": P("data", None, pol.tp_full), "_policy": pol}
    x, g = torch.zeros(2, 3, 8), torch.zeros(8, 24)       # chunks of 6
    with pytest.raises(ValueError, match="F-chunk of 6"):
        L.chunked_gated_mlp(x, g, g, g.T, acts)
    assert L.mlp_shardings(None) is None
    assert L.mlp_shardings({"acts": None, "_policy": pol}) is None
    mlp = L.mlp_shardings(acts)
    assert mlp["mlp_h"] == acts["acts"]
    assert mlp["mlp_out"] == P("data", None, None)


@pytest.mark.parametrize("dims", [
    ("data", None, ("tp_a", "tp_b", "sp")),
    (("pod", "data"), None, None),
    (None, ("data",), "tp_a", None),
    (),
])
def test_policy_act_equals_the_reference(dims):
    from jax.sharding import Mesh

    cfg = get_config("granite-3-8b", smoke=True)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    ref = ref_make_policy(mesh, ref_get_config("granite-3-8b", smoke=True),
                          batch=2, train=True)
    pol = make_policy({"data": 1, "model": 1}, cfg, batch=2, train=True,
                      hbm_bytes=16e9)
    assert pol.act(*dims) == tuple(ref.act(*dims))
    assert pol.act(*dims) == P(*dims)
