"""The port's sharding policy and spec tables (``repro_torch.models.
sharding``, ``param_specs``/``cache_specs``, ``opt_state_specs``,
``batch_specs``/``act_shardings``) against the JAX reference's, for all
10 full configs x {train, serve} x the meshes (16, 16), (2, 16, 16),
(1, 1), (2, 2), (1, 4) and (2, 1, 2), at the reference's 16e9-byte
device memory (``hbm_bytes=16e9``).  Every comparison is exact: a spec
is a tuple that equals ``tuple(PartitionSpec)`` entry for entry.

The reference needs a JAX mesh of real devices (512 for the multi-pod
mesh), so its side runs in ONE child process per module, with
``XLA_FLAGS=--xla_force_host_platform_device_count=512`` in that
child's environment only; the suite itself keeps one device.  The
port's policies need no ranks: they are computed from axis sizes.

Also: the port's copy of the reference's divisibility invariants
(``tests/test_sharding.py``), spec -> DTensor placements, and
``elastic.build_mesh`` and ``make_host_mesh`` in a world of one.
"""

import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs.base import list_archs as ref_list_archs  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import elastic as EL  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.sharding import (  # noqa: E402
    _largest_div,
    make_policy,
    placements,
)
from repro_torch.train.optimizer import OptConfig, opt_state_specs  # noqa: E402
from repro_torch.train.train_loop import act_shardings, batch_specs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the architectures the reference holds (the port adds its own beside them)
ARCHS = ref_list_archs()
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "2x1x2": ((2, 1, 2), ("pod", "data", "model")),
}
#: train at a batch every dp divides; serve at batch 1, which shards the
#: sequence wherever dp > 1 (the reference's long-context decode)
BATCH = {"train": 32, "serve": 1}
HBM = 16e9

_CHILD = textwrap.dedent("""
    import json, sys
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.configs.base import get_config, list_archs
    from repro.models import model as M
    from repro.models.sharding import make_policy
    from repro.train.optimizer import OptConfig, opt_state_specs
    from repro.train.train_loop import act_shardings, batch_specs

    meshes, batch = json.loads(sys.argv[1]), json.loads(sys.argv[2])

    def enc(spec):
        return [e if e is None or isinstance(e, str) else list(e)
                for e in tuple(spec)]

    def named(tree):
        flat = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path): enc(s) for path, s in flat}

    out = {}
    for mname, (shape, axes) in meshes.items():
        mesh = jax.make_mesh(tuple(shape), tuple(axes))
        for arch in list_archs():
            cfg = get_config(arch)
            for mode in ("train", "serve"):
                train = mode == "train"
                try:
                    pol = make_policy(mesh, cfg, batch=batch[mode],
                                      train=train)
                except Exception as e:          # noqa: BLE001
                    out[f"{mname}|{arch}|{mode}"] = {"error": repr(e)}
                    continue
                ps = M.param_specs(cfg, pol)
                shapes = jax.eval_shape(lambda: M.init_params(
                    cfg, jax.random.key(0)))
                opt = OptConfig(eightbit=cfg.opt_8bit)
                acts = act_shardings(cfg, pol)
                out[f"{mname}|{arch}|{mode}"] = {
                    "policy": [pol.tp_a, pol.tp_b, pol.sp, pol.fsdp,
                               pol.seq_shard_data, pol.weight_stationary,
                               pol.has_pod, list(pol.mesh.axis_names),
                               [int(pol.mesh.shape[a])
                                for a in pol.mesh.axis_names]],
                    "params": named(ps),
                    "cache": named(M.cache_specs(cfg, pol)),
                    "opt": named(opt_state_specs(ps, shapes, opt)),
                    "batch": named(batch_specs(cfg, pol, train=train)),
                    "acts": {k: enc(v.spec) for k, v in acts.items()
                             if k != "_policy"},
                    "expert_axes": [None if a is None else list(a)
                                    for a in pol.expert_axes(cfg)],
                }
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_tables():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    meshes = {k: [list(s), list(a)] for k, (s, a) in MESHES.items()}
    r = subprocess.run(
        [sys.executable, "-c", _CHILD, json.dumps(meshes), json.dumps(BATCH)],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _enc(spec):
    return [e if e is None or isinstance(e, str) else list(e) for e in spec]


def _named(tree, prefix=""):
    """A spec tree -> {path: encoded spec}, paths as the reference names
    them (dict keys, sequence indices)."""
    from repro_torch.models.sharding import is_spec

    if is_spec(tree):
        return {prefix: _enc(tree)}
    out = {}
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree))
    for k, v in items:
        out.update(_named(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _port_tables(mname, arch, mode):
    shape, axes = MESHES[mname]
    cfg = get_config(arch)
    train = mode == "train"
    pol = make_policy(dict(zip(axes, shape)), cfg, batch=BATCH[mode],
                      train=train, hbm_bytes=HBM)
    ps = M.param_specs(cfg, pol)
    opt = OptConfig(eightbit=cfg.opt_8bit)
    acts = act_shardings(cfg, pol)
    return {
        "policy": [pol.tp_a, pol.tp_b, pol.sp, pol.fsdp, pol.seq_shard_data,
                   pol.weight_stationary, pol.has_pod, list(pol.axis_names),
                   [s for _, s in pol.axes]],
        "params": _named(ps),
        "cache": _named(M.cache_specs(cfg, pol)),
        "opt": _named(opt_state_specs(ps, M.param_defs(cfg), opt)),
        "batch": _named(batch_specs(cfg, pol, train=train)),
        "acts": {k: _enc(v) for k, v in acts.items() if k != "_policy"},
        "expert_axes": [None if a is None else list(a)
                        for a in pol.expert_axes(cfg)],
    }


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_policy_and_specs_equal_the_reference(ref_tables, arch, mname, mode):
    ref = ref_tables[f"{mname}|{arch}|{mode}"]
    if "error" in ref:
        shape, axes = MESHES[mname]
        with pytest.raises(ValueError):
            make_policy(dict(zip(axes, shape)), get_config(arch),
                        batch=BATCH[mode], train=mode == "train",
                        hbm_bytes=HBM)
        return
    got = _port_tables(mname, arch, mode)
    for key in ("policy", "expert_axes", "batch", "acts", "params", "cache",
                "opt"):
        assert got[key] == ref[key], (key, arch, mname, mode)


def test_the_tables_cover_every_decision(ref_tables):
    """The grid reaches FSDP, weight-stationary serving, sequence
    sharding and the pod axis, so each branch above was compared."""
    pols = [v["policy"] for v in ref_tables.values() if "policy" in v]
    assert any(p[3] for p in pols), "fsdp"
    assert any(p[5] for p in pols), "weight_stationary"
    assert any(p[4] for p in pols), "seq_shard_data"
    assert any(p[6] for p in pols), "pod"
    assert len(ref_tables) == len(ARCHS) * len(MESHES) * 2


# ---------------------------------------------------------------------------
# the port's copy of tests/test_sharding.py's invariants
# ---------------------------------------------------------------------------
MODEL_AXIS = 16


def _policy_numbers(cfg):
    heads = cfg.num_heads or cfg.ssm_heads
    tp = _largest_div(heads, MODEL_AXIS)
    tp_a = math.gcd(cfg.kv_heads, tp) if cfg.kv_heads else tp
    while tp % tp_a:
        tp_a //= 2
    return tp, tp_a, tp // tp_a, MODEL_AXIS // tp


@pytest.mark.parametrize("arch", ARCHS)
def test_divisibility_invariants(arch):
    cfg = get_config(arch)
    tp, tp_a, tp_b, sp = _policy_numbers(cfg)
    pol = make_policy({"data": 16, "model": 16}, cfg, batch=16, train=True,
                      hbm_bytes=HBM)
    assert (pol.tp_a, pol.tp_b, pol.sp) == (tp_a, tp_b, sp)
    assert tp_a * tp_b * sp == MODEL_AXIS
    if cfg.num_heads:
        assert cfg.num_heads % (tp_a * tp_b) == 0, "q heads shard over tp"
        assert cfg.kv_heads % tp_a == 0, "kv heads shard over tp_a"
        assert (cfg.num_heads // cfg.kv_heads) % tp_b == 0
    if cfg.d_ff:
        assert cfg.d_ff % MODEL_AXIS == 0, "FFN features shard over model"
    assert cfg.vocab_padded % 128 == 0
    assert cfg.vocab_padded % MODEL_AXIS == 0
    if cfg.ssm_state:
        assert cfg.d_inner % MODEL_AXIS == 0
        assert cfg.ssm_heads % MODEL_AXIS == 0
    if cfg.num_experts:
        covered = 1
        for size in (tp_a, tp_b, sp):
            if size > 1 and cfg.num_experts % (covered * size) == 0:
                covered *= size
        assert cfg.d_ff % (MODEL_AXIS // covered) == 0


def test_expected_tp_assignments():
    expect = {
        "internlm2-20b": (16, 8, 2, 1), "granite-3-8b": (16, 8, 2, 1),
        "deepseek-7b": (16, 16, 1, 1), "gemma2-9b": (16, 8, 2, 1),
        "qwen2-vl-7b": (4, 4, 1, 4), "hubert-xlarge": (16, 16, 1, 1),
        "mamba2-2.7b": (16, 16, 1, 1), "mixtral-8x7b": (16, 8, 2, 1),
        "arctic-480b": (8, 8, 1, 2), "jamba-1.5-large": (16, 8, 2, 1),
    }
    for arch, want in expect.items():
        assert _policy_numbers(get_config(arch)) == want, arch


def test_policy_reads_the_device_memory_unless_given():
    cfg = get_config("granite-3-8b")
    host = make_policy({"data": 1, "model": 1}, cfg, batch=1, train=True)
    small = make_policy({"data": 1, "model": 1}, cfg, batch=1, train=True,
                        hbm_bytes=1e9)
    assert small.fsdp and not make_policy(
        {"data": 1, "model": 1}, cfg, batch=1, train=True,
        hbm_bytes=1e15).fsdp
    assert host.fsdp == (cfg.param_count() * 16 > 0.5 * os.sysconf(
        "SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))
    with pytest.raises(ValueError, match="not shardable"):
        make_policy({"data": 4, "model": 1}, cfg, batch=6, train=True,
                    hbm_bytes=HBM)
    with pytest.raises(ValueError, match="lacks a 'model' axis"):
        make_policy({"data": 4}, cfg, batch=4, train=True, hbm_bytes=HBM)


@pytest.mark.parametrize("spec,want", [
    ((("data",), None), "S0 R R R"),
    ((None, ("tp_a", "tp_b", "sp")), "R S1 S1 S1"),
    ((("tp_a", "tp_b", "sp", "data"), None), "S0 S0 S0 S0"),
    (("tp_a", None, "data"), "S2 S0 R R"),
    ((), "R R R R"),
])
def test_spec_to_placements(spec, want):
    """One placement per mesh dim; a dim split over several axes splits
    in mesh order (the weight-stationary ``wide`` included)."""
    got = placements(spec, ("data", "tp_a", "tp_b", "sp"))
    enc = " ".join(f"S{p.dim}" if p.is_shard() else "R" for p in got)
    assert enc == want
    # an axis of size 1 is no mesh dim: it replicates
    sized = placements(spec, ("data", "tp_a"), {"data": 2, "tp_a": 2,
                                                "tp_b": 1, "sp": 1})
    assert len(sized) == 2
    with pytest.raises(ValueError):
        placements((("data",), "data"), ("data",))


def test_build_mesh_and_host_mesh_in_a_world_of_one():
    """Both raise without a card unless asked for the CPU, and build a
    named mesh over the world's one rank; a plan larger than the world
    raises, naming it."""
    import torch.distributed as dist

    code = textwrap.dedent("""
        import torch.distributed as dist
        from repro_torch.launch import elastic as EL
        from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
        m = make_host_mesh(device="cpu")
        assert m.mesh_dim_names == ("data", "model") and m.mesh.shape == (1, 1)
        plan = EL.plan_mesh(1, model=1)
        bm = EL.build_mesh(plan, device="cpu")
        assert bm.mesh_dim_names == ("data", "model"), bm
        assert tuple(bm.mesh.shape) == (1, 1)
        try:
            EL.build_mesh(EL.plan_mesh(4, model=2), device="cpu")
        except RuntimeError as e:
            assert "needs 4 ranks" in str(e), e
        else:
            raise AssertionError("no error")
        try:
            make_production_mesh(device="cpu")
        except RuntimeError as e:
            assert "world of 256" in str(e), e
        else:
            raise AssertionError("no error")
        print("backend", dist.get_backend())
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "backend gloo" in r.stdout
    assert not dist.is_initialized()
    assert EL.plan_mesh(1, model=1).n_devices == 1
