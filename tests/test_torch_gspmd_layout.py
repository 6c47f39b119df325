"""The port's sharded products held to GSPMD's own: the Mamba2
in-projections (`repro_torch.models.model.ssm_shardings`), the dense MLP
under stationary weights (`repro_torch.models.layers.gated_mlp`) and the
stationary MoE's router (`repro_torch.models.moe.moe_ffn_sharded`).

Children, started together (module fixture), each with its own timeout:

- ``ref``: the reference's ``repro.launch.dryrun.lower_cell`` for
  mamba2-2.7b's long_500k and arctic-480b's prefill_32k on the 1-pod
  (16, 16) mesh, compiled, with every dot of ``compiled.as_text()``
  written as its output shape and its operands' shapes (read through
  their definitions).  JAX needs 256 host devices there, so the child
  runs with ``XLA_FLAGS=--xla_force_host_platform_device_count=512``
  (``tests/conftest.py`` bans the flag in this process);
- ``mamba``, ``arctic``: the port's ``launch.dryrun.run_cell`` of each
  cell on a fake world of 256 ranks at the reference's 16e9-byte budget,
  one cell a child;
- ``world``: a gloo world of 4 CPU ranks (``tests/test_torch_world.py``'s
  ``layout`` task): the stationary MoE on (2, 2) and (4, 1), held to the
  unsharded ``moe_ffn`` on the whole batch, which is what the port's
  stationary MoE computed when it routed every token on every rank
  (``tests/test_torch_sharded_model.py`` holds it so); and one Mamba2
  block under a train policy, FSDP, stationary weights, and a pass with
  no activation specs (a batch-1 decode step's), held to the unsharded
  block.  Both within 1e-4 of each tensor's largest magnitude.

The per-rank products must be GSPMD's: every Mamba2 in-projection of the
decode (``D`` whole, the features split over the 16 model ranks),
arctic's dense up projections (``65536x7168 @ 7168x304``, the stationary
weights gathered over "data") and its router (the rank's own 65536
tokens, not the 16 "data" ranks' 1048576).
"""

import json
import os
import re
import subprocess
import sys
import textwrap
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.sharding import P, make_policy  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_world import World  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
#: the reference's device memory, so both sides take the same policy
HBM = 16e9
CELLS = {"mamba": ("mamba2-2.7b", "long_500k"),
         "arctic": ("arctic-480b", "prefill_32k")}
#: the gloo world's MoE meshes (stationary weights: serve, 1-byte budget)
MOE_MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
#: the gloo world's Mamba2 blocks: (mesh, train, budget, batch, sequence,
#: specs); stationary weights are gathered over "data" above 1024 tokens
MAMBA_CASES = {
    "1x4-train": ((1, 4), True, HBM, 4, 16, True),
    "2x2-fsdp": ((2, 2), True, 1.0, 4, 16, True),
    "2x2-stationary-prefill": ((2, 2), False, 1.0, 4, 288, True),
    "2x2-stationary": ((2, 2), False, 1.0, 4, 16, True),
    "2x2-stationary-batch1": ((2, 2), False, 1.0, 1, 16, True),
    "2x2-no-specs": ((2, 2), False, 1.0, 1, 16, False),
}
CHILD_TIMEOUT = {"ref": 240, "mamba": 240, "arctic": 300, "world": 240}

_REF = textwrap.dedent("""
    import json, re, sys
    from collections import Counter
    from repro.launch.dryrun import lower_cell
    from repro.launch.mesh import make_production_mesh

    DEF = re.compile(r"^\\s*(?:ROOT\\s+)?%?([\\w.\\-]+)\\s*=\\s*"
                     r"(\\w+\\[[\\d,]*\\])")
    out = {}
    for name, (arch, shape) in json.loads(sys.argv[1]).items():
        lowered, pol = lower_cell(arch, shape, make_production_mesh())
        text = lowered.compile().as_text()
        shapes = {}
        for line in text.splitlines():
            m = DEF.match(line)
            if m:
                shapes[m.group(1)] = m.group(2)
        dots = Counter()
        for line in text.splitlines():
            m, call = DEF.match(line), re.search(r" dot\\(([^)]*)\\)", line)
            if m and call:
                ops = [o.strip().split(" ")[-1].lstrip("%")
                       for o in call.group(1).split(",")]
                dots[json.dumps([m.group(2)] + [shapes[o] for o in ops])] += 1
        out[name] = {"policy": [pol.tp_a, pol.tp_b, pol.sp, pol.fsdp,
                                pol.weight_stationary, pol.seq_shard_data],
                     "dots": dots}
    print(json.dumps(out))
""")

_PORT = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh

    arch, shape, hbm = sys.argv[1], sys.argv[2], float(sys.argv[3])
    D.start_fake_world(256)
    mesh = make_production_mesh(device="cpu")
    rec = D.run_cell(arch, shape, mesh, "1pod_16x16", hbm_bytes=hbm,
                     device="cpu")
    pol = D.cell_policy(D.get_config(arch), D.C.SHAPES[shape], mesh, hbm)
    rec["policy"] = [pol.tp_a, pol.tp_b, pol.sp, pol.fsdp,
                     pol.weight_stationary, pol.seq_shard_data]
    dist.destroy_process_group()
    print(json.dumps(rec))
""")


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu", **extra)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    if "XLA_FLAGS" not in extra:
        env.pop("XLA_FLAGS", None)
    return env


def _world_inputs() -> dict:
    """The gloo world's inputs, made from seeds with numpy."""
    moe_cfg = get_config("mixtral-8x7b", smoke=True)
    rng = np.random.default_rng(41)
    D, E, F_ = moe_cfg.d_model, moe_cfg.num_experts, moe_cfg.d_ff
    moe = {"arch": "mixtral-8x7b",
           "x": rng.normal(0, 1, (4, 8, D)).astype(np.float32),
           "router": rng.normal(0, 0.5, (D, E)).astype(np.float32),
           "wi_g": rng.normal(0, 0.1, (E, D, F_)).astype(np.float32),
           "wi_u": rng.normal(0, 0.1, (E, D, F_)).astype(np.float32),
           "wo": rng.normal(0, 0.1, (E, F_, D)).astype(np.float32),
           "proj": rng.normal(0, 1, (4, 8, D)).astype(np.float32)}

    cfg = get_config("mamba2-2.7b", smoke=True)
    rng = np.random.default_rng(42)
    slot = M.param_defs(cfg)["blocks"][0]
    draw = {"ssm_vec": lambda s: rng.normal(0, 0.5, s),
            "ssm_conv": lambda s: rng.normal(0, 0.3, s)}
    weights = {k: draw.get(d.role, lambda s: rng.normal(0, 0.2, s))(
        d.shape[1:]).astype(np.float32) for k, d in slot.items()}
    weights["dt_bias"] -= 2.0                 # softplus's small steps
    return {"moe_inputs": moe,
            "moe": {n: {"mesh": m, "variants": {"weight_stationary":
                                                 (1.0, False)}}
                    for n, m in MOE_MESHES.items()},
            "mamba_arch": "mamba2-2.7b", "mamba_weights": weights,
            "mamba_x": rng.normal(0, 1, (4, 288, cfg.d_model)).astype(
                np.float32),
            "mamba_dy": rng.normal(0, 1, (4, 288, cfg.d_model)).astype(
                np.float32),
            "mamba": MAMBA_CASES}


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Every child of this module, started at once, each writing to a log
    of its own (a pipe left unread would stall a child that fills it)."""
    work = tmp_path_factory.mktemp("gspmd_layout")
    logs = {n: open(work / f"{n}.log", "w+") for n in ("ref", *CELLS)}

    def start(name, args, env):
        return subprocess.Popen([sys.executable, "-c", *args], env=env,
                                stdout=logs[name], stderr=subprocess.STDOUT,
                                text=True)

    procs = {"ref": start("ref", [_REF, json.dumps(CELLS)], _env(
        XLA_FLAGS="--xla_force_host_platform_device_count=512"))}
    for name, (arch, shape) in CELLS.items():
        procs[name] = start(name, [_PORT, arch, shape, str(HBM)], _env())
    world = World("layout", 4, work / "world", _world_inputs(),
                  timeout=CHILD_TIMEOUT["world"])
    t0 = time.time()
    try:
        yield {"procs": procs, "world": world, "t0": t0, "logs": logs,
               "done": {}}
    finally:
        for p in list(procs.values()) + world.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs.values():
            f.close()


def _result(children, name):
    done = children["done"]
    if name in done:
        return done[name]
    if name == "world":
        done[name] = children["world"].result()
        return done[name]
    p = children["procs"][name]
    try:
        p.wait(timeout=max(1.0, children["t0"] + CHILD_TIMEOUT[name]
                           - time.time()))
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
    f = children["logs"][name]
    f.seek(0)
    out = f.read()
    assert p.returncode == 0, f"{name} (rc {p.returncode}):\n{out[-3000:]}"
    done[name] = json.loads(out.strip().splitlines()[-1])
    return done[name]


def _dims(shape: str) -> tuple:
    """``"f32[65536,7168]"`` -> (65536, 7168)."""
    inner = re.search(r"\[([\d,]*)\]", shape).group(1)
    return tuple(int(d) for d in inner.split(",") if d)


def gspmd_products(dots: dict) -> Counter:
    """GSPMD's matrix-vector and matrix products as (M, K, N) (M = 1 for
    a vector), each counted as often as the program holds it: a dot of a
    (M, K) or (K,) operand with a (K, N) one."""
    out = Counter()
    for key, n in dots.items():
        res, *ops = (_dims(s) for s in json.loads(key))
        if len(ops) == 2 and len(ops[0]) in (1, 2) and len(ops[1]) == 2 \
                and ops[0][-1] == ops[1][0] and res[-1:] == ops[1][1:]:
            m = ops[0][0] if len(ops[0]) == 2 else 1
            out[m, ops[0][-1], ops[1][1]] += n
    return out


def port_products(flops_by_op: dict) -> dict:
    """The port's ``mm`` products and ``bmm`` products of one batch as
    (op name, M, K, N) -> FLOPs: ``"bmm 1x65536x7168 @ 1x7168x304"`` ->
    ("bmm", 65536, 7168, 304)."""
    out = {}
    for key, flops in flops_by_op.items():
        name, rest = key.split(" ", 1)
        a, b = ([int(d) for d in t.split("x")] for t in rest.split(" @ "))
        if name == "mm" or (name == "bmm" and a[0] == 1 and b[0] == 1):
            out[(name, a[-2], a[-1], b[-1])] = flops
    return out


def _cell(children, name):
    ref, port = _result(children, "ref")[name], _result(children, name)
    assert port["ok"], port.get("trace")
    assert port["policy"] == ref["policy"], (port["policy"], ref["policy"])
    return gspmd_products(ref["dots"]), port_products(port["flops_by_op"]), \
        port


# ---------------------------------------------------------------------------
# the products at GSPMD's share (fake world of 256 against XLA's program)
# ---------------------------------------------------------------------------
def _mamba_in_projections():
    """(K, N) of each Mamba2 in-projection of mamba2-2.7b, a rank's share:
    D whole, d_inner, the state and the heads over the 16 model ranks."""
    cfg = get_config("mamba2-2.7b")
    d_inner = cfg.ssm_heads * cfg.ssm_head_dim
    return {"w_x": (cfg.d_model, d_inner // 16),
            "w_z": (cfg.d_model, d_inner // 16),
            "w_B": (cfg.d_model, cfg.ssm_state // 16),
            "w_C": (cfg.d_model, cfg.ssm_state // 16),
            "w_dt": (cfg.d_model, cfg.ssm_heads // 16)}


@pytest.mark.parametrize("weight", list(_mamba_in_projections()))
def test_mamba2_in_projection_runs_gspmds_dot(children, weight):
    gspmd, port, _ = _cell(children, "mamba")
    cfg = get_config("mamba2-2.7b")
    K, N = _mamba_in_projections()[weight]
    # a decode step: one token; the reference's loop body holds a layer
    # once, the port runs the 64 layers one by one
    same = sum(1 for k, n in _mamba_in_projections().values() if n == N)
    assert gspmd[(1, K, N)] == same, sorted(gspmd)
    assert port[("bmm", 1, K, N)] == same * 2 * K * N * cfg.num_layers


def test_mamba2_decode_runs_every_product_as_gspmd(children):
    gspmd, port, _ = _cell(children, "mamba")
    # the in-projections, the SSD readout, the out projection and the
    # head (D whole: torch 2.13 split it over 16 ranks without a layout)
    assert set(gspmd) == {k[1:] for k in port if k[0] == "bmm"}, (
        sorted(gspmd), sorted(port))


def test_mamba2_in_projections_split_nothing_else(children):
    gspmd, port, _ = _cell(children, "mamba")
    cfg = get_config("mamba2-2.7b")
    D, d_inner = cfg.d_model, cfg.ssm_heads * cfg.ssm_head_dim
    # DTensor's plan on torch 2.13 before the layouts were pinned: w_x and
    # w_z with D over "data" (partial sums), B, C and dt whole
    for mkn in ((1, D // 16, d_inner // 16), (1, D, cfg.ssm_state),
                (1, D, cfg.ssm_heads)):
        assert ("bmm",) + mkn not in port, sorted(port)
        assert mkn not in gspmd


def test_arctic_dense_up_projections_run_gspmds_dot(children):
    gspmd, port, _ = _cell(children, "arctic")
    cfg = get_config("arctic-480b")
    # 2 prompts x 32768 tokens a "data" rank; F over the 16 model ranks
    mkn = (65536, cfg.d_model, cfg.d_ff // 16)
    assert gspmd[mkn] == 2
    assert port[("bmm",) + mkn] == 2 * 2 * 65536 * cfg.d_model \
        * (cfg.d_ff // 16) * cfg.num_layers
    # D over tp_a (8) and F whole: twice the share
    assert ("bmm", 65536, cfg.d_model // 8, cfg.d_ff) not in port


def test_arctic_router_runs_on_the_ranks_own_tokens(children):
    gspmd, port, rec = _cell(children, "arctic")
    cfg = get_config("arctic-480b")
    mkn = (65536, cfg.d_model, cfg.num_experts)
    assert gspmd[mkn] >= 1               # the router (beside k and v)
    routers = {k: v for k, v in port.items()
               if k[0] == "mm" and k[2:] == mkn[1:]}
    assert routers == {("mm",) + mkn: 2.0 * 65536 * cfg.d_model
                       * cfg.num_experts * cfg.num_layers}, routers
    # the reference's FLOPs less the two dropped shares: 3.196e14 a rank
    # where routing every "data" rank's tokens and the up projections
    # at D/8 read 4.028e14; the output's sum no longer all-reduces every
    # token (3.157e12 bytes a rank)
    assert rec["flops"] <= 3.4e14
    assert rec["collective_bytes_by_kind"]["all-reduce"] < 3.157e12 / 2


# ---------------------------------------------------------------------------
# the values (gloo world of 4)
# ---------------------------------------------------------------------------
def _close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= TOL * float(np.abs(want).max()), err


@pytest.mark.parametrize("mesh", list(MOE_MESHES))
def test_stationary_moe_matches_routing_every_token_together(children,
                                                              mesh):
    got = _result(children, "world")["moe"][mesh]["weight_stationary"]
    assert got["ws"] and got["dp"] == MOE_MESHES[mesh][0]
    plain = got["plain"]
    _close(got["y"], plain["y"])
    assert abs(got["aux"] - plain["aux"]) <= TOL * abs(plain["aux"])
    assert len(got["grads"]) == 5
    for g, want in zip(got["grads"], plain["grads"]):
        _close(g, want)


@pytest.mark.parametrize("case", list(MAMBA_CASES))
def test_sharded_mamba2_block_matches_the_unsharded_one(children, case):
    got = _result(children, "world")["mamba"][case]
    mesh, train, _, batch, _, _ = MAMBA_CASES[case]
    tp_a, tp_b, sp, dp, fsdp, ws, seq = got["policy"]
    assert (tp_a * tp_b * sp, dp) == (mesh[1], mesh[0])
    assert ws == (not train and mesh[0] > 1) and seq == (batch < dp)
    _close(*got["y"])
    _close(*got["h"])
    assert set(got["grads"]) == {"x", "w_x", "w_z", "w_B", "w_C", "w_dt",
                                 "w_out"}
    for a, b in got["grads"].values():
        _close(a, b)


# ---------------------------------------------------------------------------
# in-process: the layouts themselves
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["train", "prefill", "decode",
                                  "decode-2pod", "decode-batch1"])
def test_ssm_shardings_follow_the_weights_roles(kind):
    from repro_torch.train.train_loop import act_shardings

    # (train, batch, a pass's tokens, specs): a train step's microbatch
    train, batch, n, acts = {"train": (True, 256, 64 * 4096, True),
                             "prefill": (False, 32, 32 * 32768, True),
                             "decode": (False, 128, 128, True),
                             "decode-2pod": (False, 128, 128, True),
                             "decode-batch1": (False, 1, 1, False)}[kind]
    cfg = get_config("jamba-1.5-large")
    mesh = {"data": 16, "model": 16}
    if kind == "decode-2pod":
        mesh = {"pod": 2, **mesh}
    pol = make_policy(mesh, cfg, batch=batch, train=train, hbm_bytes=HBM)
    ssm = M.ssm_shardings(
        cfg, act_shardings(cfg, pol) if acts else {"_policy": pol}, n)
    assert pol.fsdp == train and pol.weight_stationary == (not train)
    tp = pol.tp_full
    # a decode step keeps its stationary weights and takes the tokens
    # whole over "data": the features of xz, z over the model axes and
    # "data"; "pod" keeps its tokens
    whole = kind.startswith("decode")
    toks = {"decode-2pod": ("pod", None)}.get(
        kind, (None, None) if whole else ("data", None))
    inner = tp + ("data",) if whole else tp
    assert ssm["ssm_rows"] == P(*toks, None)
    assert ssm["ssm_inner"] == P(*toks, inner)
    assert ssm["w_ssm_inner"] == P(None, inner)
    assert ssm["w_ssm_out"] == P(inner, None)
    for name in ("ssm_state", "ssm_dt"):
        assert ssm[name] == P(*toks, tp)
        assert ssm["w_" + name] == P(None, tp)


def test_ssm_shardings_without_a_policy_is_none():
    cfg = get_config("mamba2-2.7b", smoke=True)
    assert M.ssm_shardings(cfg, None, 1) is None
    assert M.ssm_shardings(cfg, {}, 1) is None
