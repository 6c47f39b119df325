"""The port's dry run and roofline (`repro_torch.launch.dryrun`,
`repro_torch.launch.roofline`) on fake worlds, against the reference's.

Every fake world runs in a child process of its own, so no process group
is left behind in the test process; the reference's dry run and roofline
set ``XLA_FLAGS`` when imported, so they run in a child too, on 4 host
devices.  The children start together (module fixtures) and the tests
read their JSON:

- the reference's ``lower_cell`` on a (2, 2) jax mesh and the port's
  ``run_cell`` on a fake (2, 2) world, at smoke size: the policy fields
  and ``arg_bytes_per_dev`` are equal (every leaf there splits evenly, so
  no XLA padding enters);
- the counting rule on the fake (2, 2) world: one product's FLOPs, an
  all-gather's and an all-reduce's operand bytes; the unsharded step's
  FLOPs equal the sum over the four ranks' shards of a dense arch;
  train and prefill counts composed from 2 and 3 groups equal a traced
  4-group step;
- the two repairs (a fake trace of the sharded decode writes the cache
  through ``shard_extent`` and routes mixtral's experts through
  ``expert_counts``), and ``shard_extent`` against torch's own helper;
- ``place`` with a placed DTensor, ``_wsc``'s constraint on the
  gradient (mamba2's gate gradient product split over the model axis),
  and ``flops_by_op``;
- granite-3-8b ``decode_32k`` at full width on the fake (16, 16) world,
  through ``python -m repro_torch.launch.dryrun``, then the roofline CLI
  on its record.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import cells as C  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import roofline as R  # noqa: E402
from repro_torch.models.moe import expert_counts  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: one cell of each kind (and mixtral's MoE decode, long_500k's sequence
#: sharding), at smoke size on a (2, 2) mesh with the reference's 16 GB
CELLS = [("granite-3-8b", "train_4k"), ("granite-3-8b", "prefill_32k"),
         ("granite-3-8b", "decode_32k"), ("hubert-xlarge", "prefill_32k"),
         ("mixtral-8x7b", "decode_32k"), ("mamba2-2.7b", "long_500k")]
#: jax.jit drops an argument its function never reads (keep_unused=False):
#: hubert's encoder forward never reads the text embedding, so the
#: reference's argument bytes leave out its local shard (vocab over the
#: model axis of 2, float32), and mamba2's decode never reads cur_len
#: (int32); the port's count keeps every input, and the
#: test adds them to the reference's
UNREAD = {("hubert-xlarge", "prefill_32k"):
          lambda cfg: cfg.vocab_padded // 2 * cfg.d_model * 4,
          ("mamba2-2.7b", "long_500k"): lambda cfg: 4}
#: XLA's FLOP count adds one per element of every elementwise op; the
#: port's counts products only.  In the smoke decode cell (width 64
#: against a 32768-long cache) the softmax's elementwise work over the
#: cache is close to the products', so the port reads 0.571 of the
#: reference's count (measured); it may read less, never more.
XLA_FLOPS_RATIO = (0.5, 1.0)

_REF = textwrap.dedent("""
    import json, sys
    from repro.launch import dryrun as RD
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs.base import get_config
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    out = {}
    for arch, shape in json.loads(sys.argv[1]):
        lowered, pol = RD.lower_cell(arch, shape, mesh, smoke=True)
        ma = lowered.compile().memory_analysis()
        out[f"{arch}|{shape}"] = {
            "tp": [pol.tp_a, pol.tp_b, pol.sp], "fsdp": pol.fsdp,
            "seq_shard": pol.seq_shard_data,
            "arg_bytes_per_dev": ma.argument_size_in_bytes}
    from repro.launch import roofline as RR
    out["model_flops"] = {f"{a}|{s}": RR.model_flops(a, s)
                          for a, s, ok, _ in RD.C.all_cells() if ok}
    # the reference's roofline of the smoke decode cell on 4 chips
    RR.get_config = lambda arch: get_config(arch, smoke=True)
    rec = RR.analyze_cell("granite-3-8b", "decode_32k", mesh, 4)
    out["roofline_decode_flops"] = rec["flops_per_dev"]
    print(json.dumps(out))
""")

_PORT = textwrap.dedent("""
    import json, sys
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, empty
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import PRODUCTION_AXES, make_mesh

    D.start_fake_world(4)
    mesh = make_mesh((2, 2), PRODUCTION_AXES, device="cpu")
    dev = torch.device("cpu")
    out = {"cells": {}}
    for arch, shape in json.loads(sys.argv[1]):
        rec = D.run_cell(arch, shape, mesh, "2x2", smoke=True,
                         hbm_bytes=16e9, device="cpu")
        rec.pop("trace", None)
        out["cells"][f"{arch}|{shape}"] = rec
    if sys.argv[2] == "cells":
        print(json.dumps(out))
        sys.exit(0)

    # one product, one all-gather, one all-reduce
    def one(fn, *args):
        return D.measure(fn, args)
    with FakeTensorMode():
        a = empty(64, 32, device_mesh=mesh, placements=[Shard(0), Replicate()])
        b = empty(32, 16, device_mesh=mesh, placements=[Replicate(), Shard(1)])
        out["product"] = one(torch.matmul, a, b)
        x = empty(8, 6, device_mesh=mesh, placements=[Shard(0), Replicate()])
        out["gather"] = one(lambda t: t.redistribute(
            mesh, [Replicate(), Replicate()]), x)
        a = empty(64, 32, device_mesh=mesh, placements=[Replicate(), Shard(1)])
        b = empty(32, 16, device_mesh=mesh, placements=[Replicate(), Shard(0)])
        out["reduce"] = one(lambda p, q: (p @ q).redistribute(
            mesh, [Replicate(), Replicate()]), a, b)

    # place: a DTensor already laid out by its spec passes as it is; one
    # laid out otherwise raises
    from repro_torch.models.model import place
    cfg = get_config("granite-3-8b", smoke=True)
    pol = D.cell_policy(cfg, D.C.SHAPES["decode_32k"], mesh, 16e9)
    with FakeTensorMode():
        spec = ("data", None)
        t = empty(8, 6, device_mesh=pol.mesh,
                  placements=pol.placements(spec))
        out["place_same"] = place(t, pol, spec) is t
        try:
            place(t, pol, (None, None))
            out["place_other"] = "returned"
        except ValueError as e:
            out["place_other"] = str(e)

    # _wsc constrains the gradient as the value: a gradient that comes
    # back replicated is laid out by the spec again
    from repro_torch.models.model import _wsc
    with FakeTensorMode():
        spec = ("data", "tp_a")
        x = empty(8, 6, device_mesh=pol.mesh,
                  placements=pol.placements(spec), requires_grad=True)
        y = _wsc(x, {"c": spec, "_policy": pol}, "c")
        whole = y.redistribute(pol.mesh, [Replicate(), Replicate()])
        [g] = torch.autograd.grad((whole * whole).sum(), [x])
        out["wsc_grad"] = [repr(p) for p in g.placements]
        out["wsc_spec"] = [repr(p) for p in pol.placements(spec)]

    # mamba2's train step with one sequence a rank a microbatch: the
    # gate's gradient comes back split over the tokens unless _wsc lays
    # it out by "ssm_inner" again
    mcfg = get_config("mamba2-2.7b", smoke=True)
    mshape = D.C.Shape("t", 256, 8, "train")
    mpol = D.cell_policy(mcfg, mshape, mesh, 16e9)
    out["mamba_ops"] = list(D.trace_step(mcfg, mshape, mpol,
                                         dev)["flops_by_op"])

    # the unsharded step against the four ranks' shards
    for kind, shape in (("decode", D.C.Shape("d", 512, 8, "decode")),
                        ("prefill", D.C.Shape("p", 512, 8, "prefill")),
                        ("train", D.C.Shape("t", 256, 16, "train"))):
        pol = D.cell_policy(cfg, shape, mesh, 16e9)
        out[f"whole|{kind}"] = D.trace_step(cfg, shape, None, dev)["flops"]
        out[f"rank|{kind}"] = D.trace_step(cfg, shape, pol, dev)["flops"]
        out[f"tp|{kind}"] = [pol.tp_a, pol.tp_b, pol.sp, pol.fsdp]

    # counts composed from 2 and 3 groups against 4 groups traced
    for arch, shape in (("granite-3-8b", D.C.Shape("t", 256, 16, "train")),
                        ("mixtral-8x7b", D.C.Shape("t", 256, 16, "train")),
                        ("granite-3-8b", D.C.Shape("p", 2048, 8, "prefill")),
                        ("mamba2-2.7b", D.C.Shape("p", 512, 8, "prefill"))):
        cfg = D.at_groups(get_config(arch, smoke=True), 4)
        pol = D.cell_policy(cfg, shape, mesh, 16e9)
        c2, c3, c4 = (D.trace_step(D.at_groups(cfg, g), shape, pol, dev)
                      for g in (2, 3, 4))
        out[f"composed|{arch}|{shape.kind}"] = [D.compose(c2, c3, 4), c4]
    print(json.dumps(out))
""")

_SHARDS = textwrap.dedent("""
    import itertools, json
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.models.sharding import shard_extent

    checked = 0
    for mesh_shape in ((8,), (2, 4), (2, 2, 2)):
        for rank in range(8):
            dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                    world_size=8)
            mesh = DeviceMesh("cpu", torch.arange(8).reshape(mesh_shape))
            sizes = [mesh.size(i) for i in range(mesh.ndim)]
            # S even (32) and uneven (7, 13, 3, 5) on dims 1 and 2 of a
            # 4-d cache; each mesh dim splits one of them or neither
            choices = [Replicate(), Shard(1), Shard(2)]
            for shape in ((4, 32, 6, 3), (4, 7, 13, 3), (2, 3, 5, 1)):
                for pls in itertools.product(choices, repeat=mesh.ndim):
                    want = compute_local_shape_and_global_offset(
                        shape, mesh, pls)
                    got = shard_extent(shape, sizes, mesh.get_coordinate(),
                                       pls)
                    assert (tuple(got[0]), tuple(got[1])) == (
                        tuple(want[0]), tuple(want[1])), (
                        mesh_shape, rank, shape, pls, got, want)
                    checked += 1
            dist.destroy_process_group()
    print(json.dumps({"checked": checked}))
""")


def _env(ref: bool) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    if ref:
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    return env


def _start(args, ref=False, cwd=None):
    return subprocess.Popen([sys.executable, *args], env=_env(ref), cwd=cwd,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _json(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Every child of this module, started at once."""
    cells = json.dumps(CELLS)
    tmp = tmp_path_factory.mktemp("dryrun")
    procs = {
        "ref": _start(["-c", _REF, cells], ref=True),
        "cells": _start(["-c", _PORT, cells, "cells"]),
        "rule": _start(["-c", _PORT, "[]", "rule"]),
        "shards": _start(["-c", _SHARDS]),
        "full": _start(["-m", "repro_torch.launch.dryrun", "--device", "cpu",
                        "--arch", "granite-3-8b", "--shape", "decode_32k",
                        "--multi-pod", "single", "--out",
                        str(tmp / "full.json")], cwd=tmp),
        "both": _start(["-m", "repro_torch.launch.dryrun", "--device", "cpu",
                        "--arch", "hubert-xlarge", "--shape", "decode_32k",
                        "--out", str(tmp / "both.json")], cwd=tmp),
    }
    try:
        yield {"procs": procs, "tmp": tmp, "done": {}}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


def _result(children, name):
    done = children["done"]
    if name not in done:
        p = children["procs"][name]
        if name in ("full", "both"):
            out, err = p.communicate(timeout=600)
            done[name] = (p.returncode, out, err)
        else:
            done[name] = _json(p)
    return done[name]


# ---------------------------------------------------------------------------
# in-process: no world
# ---------------------------------------------------------------------------
def test_importing_the_modules_starts_no_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    assert D.MICROBATCH == 4 and R.PEAK_FLOPS == 989e12


def test_expert_counts_equal_bincount():
    rng = np.random.default_rng(0)
    for E, shape in ((8, (2, 37)), (128, (2, 1000)), (16, (5,))):
        ids = torch.as_tensor(rng.integers(0, E, shape))
        assert torch.equal(expert_counts(ids, E),
                           torch.bincount(ids.reshape(-1), minlength=E))


def test_measure_counts_bytes_and_live_storage():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(1000)
        out = D.measure(lambda t: t * 2 + 1, (x,))
        assert out["flops"] == 0
        assert out["bytes"] == 4 * 4000          # two ops, in + out each
        assert out["arg_bytes_per_dev"] == 4000
        assert out["out_bytes_per_dev"] == 4000
        assert out["peak_bytes_per_dev"] == 12000  # x, t * 2, the result
        assert out["tmp_bytes_per_dev"] == 4000
        assert out["alias_bytes_per_dev"] == 0
        y = torch.empty(1000)
        inplace = D.measure(lambda t: t.mul_(2), (y,), scalars=1)
        assert inplace["alias_bytes_per_dev"] == 4000
        assert inplace["arg_bytes_per_dev"] == 4004
        assert inplace["peak_bytes_per_dev"] == 4000
        mm = D.measure(torch.matmul, (torch.empty(8, 16), torch.empty(16, 4)))
        assert mm["flops"] == 2 * 8 * 16 * 4


def test_roofline_terms_use_the_h100_data_sheet():
    t = R.roofline_terms(989e12, 3.35e12 * 2, 450e9 * 0.5)
    assert (t["t_compute_s"], t["t_memory_s"], t["t_collective_s"]) == (
        1.0, 2.0, 0.5)
    assert t["dominant"] == "memory" and t["step_time_s"] == 2.0
    assert t["mfu_proxy"] == 0.5
    assert (R.HBM_BW, R.LINK_BW, R.HBM_BYTES) == (3.35e12, 450e9, 80e9)


# ---------------------------------------------------------------------------
# against the reference's dry run on a (2, 2) mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_policy_and_arg_bytes_equal_the_reference(children, arch, shape):
    ref = _result(children, "ref")[f"{arch}|{shape}"]
    got = _result(children, "cells")["cells"][f"{arch}|{shape}"]
    assert got["ok"], got.get("error")
    assert list(got["tp"]) == ref["tp"]
    assert (got["fsdp"], got["seq_shard"]) == (ref["fsdp"], ref["seq_shard"])
    unread = UNREAD.get((arch, shape), lambda cfg: 0)(
        C.get_config(arch, smoke=True))
    assert got["arg_bytes_per_dev"] == ref["arg_bytes_per_dev"] + unread
    assert got["peak_bytes_per_dev"] >= got["arg_bytes_per_dev"]
    assert set(got["collective_counts"]) <= set(D.COLLECTIVES)


def test_model_flops_equal_the_reference(children):
    ref = _result(children, "ref")["model_flops"]
    for key, v in ref.items():
        assert R.model_flops(*key.split("|")) == v, key


def test_flops_against_the_reference_roofline(children):
    """XLA counts elementwise ops as FLOPs, the port products only."""
    ref = _result(children, "ref")["roofline_decode_flops"]
    got = _result(children, "cells")["cells"]["granite-3-8b|decode_32k"]
    lo, hi = XLA_FLOPS_RATIO
    assert lo * ref <= got["flops"] <= hi * ref, (got["flops"], ref)


# ---------------------------------------------------------------------------
# the counting rule
# ---------------------------------------------------------------------------
def test_a_product_counts_its_ranks_share(children):
    # (64, 32) rows over "data" @ (32, 16) columns over "model": each rank
    # multiplies (32, 32) @ (32, 16)
    got = _result(children, "rule")["product"]
    assert got["flops"] == 2 * 64 * 32 * 16 / 4
    assert got["collective_bytes"] == 0


def test_collectives_count_their_local_operand_bytes(children):
    port = _result(children, "rule")
    # rank 0's (4, 6) float32 rows gathered over "data"
    assert port["gather"]["collective_counts"] == {"all-gather": 1}
    assert port["gather"]["collective_bytes"] == 4 * 6 * 4
    # a (64, 16) float32 partial sum over "model"
    assert port["reduce"]["collective_counts"] == {"all-reduce": 1}
    assert port["reduce"]["collective_bytes"] == 64 * 16 * 4
    assert port["reduce"]["flops"] == 2 * 64 * 16 * 16


def test_place_takes_a_dtensor_only_as_its_spec_lays_it_out(children):
    port = _result(children, "rule")
    assert port["place_same"] is True
    assert port["place_other"].startswith("a DTensor laid out"), \
        port["place_other"]


def test_a_constraint_lays_out_the_gradient_as_the_value(children):
    port = _result(children, "rule")
    assert port["wsc_grad"] == port["wsc_spec"] == ["Shard(dim=0)",
                                                    "Shard(dim=1)"]


def test_no_rank_runs_the_mamba_gate_gradient_whole(children):
    """Without the gradient's constraint, w_z's gradient product ran with
    the inner width (128 at smoke size, 64 a rank) whole on every model
    rank: ``bmm 1x64x256 @ 1x256x128``."""
    d_inner = C.get_config("mamba2-2.7b", smoke=True).d_inner
    ops = _result(children, "rule")["mamba_ops"]
    assert ops and all(
        str(d_inner) not in dims.split("x")
        for op in ops for dims in op.split(" ", 1)[1].split(" @ ")), ops


def test_flops_by_op_add_up_to_the_flops(children):
    for rec in _result(children, "cells")["cells"].values():
        assert sum(rec["flops_by_op"].values()) == pytest.approx(
            rec["flops"], rel=1e-12), rec["arch"]
    assert _result(children, "rule")["product"]["flops_by_op"] == {
        "mm 32x32 @ 32x8": 2 * 32 * 32 * 8}


@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
def test_rank_flops_summed_over_shards_equal_the_unsharded_step(children,
                                                                kind):
    """granite-3-8b smoke on (2, 2): data 2 x tp_a 2; every product
    splits over all four ranks (batch over data, heads, features and
    vocabulary over tp_a), so the four shards add up to the one-device
    step exactly."""
    port = _result(children, "rule")
    assert port[f"tp|{kind}"] == [2, 1, 1, False]
    assert 4 * port[f"rank|{kind}"] == port[f"whole|{kind}"]


@pytest.mark.parametrize("arch,kind", [
    ("granite-3-8b", "train"), ("mixtral-8x7b", "train"),
    ("granite-3-8b", "prefill"), ("mamba2-2.7b", "prefill")])
def test_composed_counts_equal_a_traced_step(children, arch, kind):
    composed, traced = _result(children, "rule")[
        f"composed|{arch}|{kind}"]
    for k in ("flops", "bytes", "collective_bytes", "collective_counts",
              "collective_bytes_by_kind", "arg_bytes_per_dev",
              "out_bytes_per_dev", "alias_bytes_per_dev"):
        assert composed[k] == traced[k], k
    # the live storage's peak: one float32 scalar (the MoE aux loss) dies
    # at another op in the 2-group step than in deeper ones
    for k in ("peak_bytes_per_dev", "tmp_bytes_per_dev"):
        assert abs(composed[k] - traced[k]) <= 4, k


# ---------------------------------------------------------------------------
# the repairs
# ---------------------------------------------------------------------------
def test_shard_extent_equals_torchs_helper(children):
    # 3 meshes x every rank x 3 shapes x every placement choice
    assert _result(children, "shards")["checked"] == 3 * (
        8 * 3 ** 1 + 8 * 3 ** 2 + 8 * 3 ** 3)


@pytest.mark.parametrize("arch", ["granite-3-8b", "mixtral-8x7b"])
def test_sharded_decode_traces_under_fake_tensors(children, arch):
    """The cache write (``_write`` through ``shard_extent``) and, for
    mixtral, the expert counts (``expert_counts``) run on fake tensors."""
    got = _result(children, "cells")["cells"][f"{arch}|decode_32k"]
    assert got["ok"], got.get("error")
    # the cache is written in place: the output aliases it
    assert got["alias_bytes_per_dev"] > 0


# ---------------------------------------------------------------------------
# full width on the production mesh, through the CLIs
# ---------------------------------------------------------------------------
def test_full_width_decode_on_the_fake_production_mesh(children):
    rc, out, err = _result(children, "full")
    assert rc == 0, err[-4000:]
    [rec] = json.loads((children["tmp"] / "full.json").read_text())
    assert rec["ok"] and rec["mesh"] == "1pod_16x16", rec.get("error")
    assert tuple(rec["tp"]) == (8, 2, 1) and not rec["fsdp"]
    cfg = C.get_config("granite-3-8b")
    B, S = 128, 32768
    D_, H, K, hd = cfg.d_model, cfg.num_heads, cfg.kv_heads, \
        cfg.resolved_head_dim
    per_token = (2 * D_ * (H + 2 * K) * hd + 2 * H * hd * D_
                 + 6 * D_ * cfg.d_ff + 4 * H * S * hd)
    whole = B * (cfg.num_layers * per_token + 2 * D_ * cfg.vocab_padded)
    # every product splits over the 256 ranks but the KV projections,
    # whose 8 heads split over tp_a (8) and repeat on the 2 tp_b ranks
    kv_repeat = cfg.num_layers * B * 2 * 2 * D_ * K * hd
    assert rec["flops"] == (whole + kv_repeat) / 256
    # the tokens arrive placed: the step moves no token batch
    assert set(rec["collective_counts"]) <= {"all-gather", "all-reduce"}
    assert rec["peak_bytes_per_dev"] < R.HBM_BYTES


def test_roofline_cli_reads_the_dry_runs_record(children):
    rc, _, err = _result(children, "full")
    assert rc == 0, err[-4000:]
    tmp = children["tmp"]
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--device",
         "cpu", "--arch", "granite-3-8b", "--shape", "decode_32k",
         "--dryrun", str(tmp / "full.json"), "--out", str(tmp / "rl.json")],
        env=_env(False), cwd=tmp, capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 0, r.stderr[-4000:]
    [rec] = json.loads((tmp / "rl.json").read_text())
    [dry] = json.loads((tmp / "full.json").read_text())
    assert rec["flops_per_dev"] == dry["flops"]
    assert rec["t_compute_s"] == dry["flops"] / 989e12
    assert rec["t_memory_s"] == dry["bytes"] / 3.35e12
    assert rec["dominant"] == "memory" and rec["fits_hbm"]
    assert rec["useful_ratio"] == pytest.approx(
        R.model_flops("granite-3-8b", "decode_32k")
        / (dry["flops"] * 256))


def test_both_meshes_run_in_two_children(children):
    rc, out, err = _result(children, "both")
    assert rc == 0, err[-4000:]
    recs = json.loads((children["tmp"] / "both.json").read_text())
    assert [(r["mesh"], r["skipped"]) for r in recs] == [
        ("1pod_16x16", True), ("2pod_2x16x16", True)]
