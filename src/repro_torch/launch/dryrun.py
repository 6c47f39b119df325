"""Multi-pod dry run: trace every (architecture × input shape) cell's step
on the production meshes, at full width and zero allocation, and record
one rank's work, collectives and memory.

    PYTHONPATH=src python -m repro_torch.launch.dryrun              # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-2.7b \\
        --shape long_500k --multi-pod both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
        --out dryrun_results_torch.json

The port's counterpart of `repro.launch.dryrun`.  Where the reference
lowers and compiles each step for 512 host devices and reads XLA's cost
and memory analyses, the port runs the step once, eagerly, on fake
tensors (``FakeTensorMode``: shapes and dtypes, no memory, nothing
launched; on the card by default, ``--device cpu`` on the host) in a fake
world of 256 or 512 ranks (``torch.distributed``'s ``"fake"`` backend:
collectives return at once) as rank 0, and counts what rank 0's ops do.
The steps are the port's own: ``make_train_step`` (microbatch 4, as the
reference), ``make_prefill_step``, ``make_decode_step``, and the
encoder-only forward for hubert.

**The world.**  :func:`start_fake_world` starts it, and only :func:`main`
calls it: importing this module starts no process group.  ``make_mesh``
wants the world to equal the mesh, so each mesh runs in a process of its
own; ``--multi-pod both`` runs the 1-pod and the 2-pod mesh in two child
processes.

**The inputs** are placed before the step, as the reference's
``in_shardings`` place them: fake DTensors laid out by ``param_specs``,
the moments of ``init_opt_state``, ``init_cache`` and the batch's specs,
so no scatter of the tokens counts as the step's.  The scalar inputs (the
step index, ``cur_len`` = the cache's length) are Python ints to the
port's steps; their 4 bytes each count in ``arg_bytes_per_dev``, as the
reference's int32 scalars.

**Counting one rank's work** (:class:`CostMode`).  Every op is counted
as rank 0 runs it.  A DTensor op is not counted at its global shapes: it
is let through to DTensor, and the local ops DTensor runs on rank 0's
shards (its redistributions' collectives among them) come back to the
counter at their local shapes.  An op of a per-rank body (``run_local``)
runs on local tensors and is counted at its own shapes.  So an op whose
output splits over n ranks (``Shard`` or ``Partial`` on those mesh dims)
counts 1/n of its global work (rank 0's piece, the larger one of an
uneven split), and a replicated op counts whole.  DTensor's sharding
propagation, which runs an op once more at global shapes to learn its
output's shape (and caches that), is not counted.

- ``flops``: products only, by ``torch.utils.flop_counter``'s formulas
  (2·M·N·K a matrix product); XLA's count adds one an elementwise op.
  ``flops_by_op`` splits them by op and local operand shapes (``"mm
  8192x2560 @ 2560x160"``), which names the products a rank runs whole.
- ``bytes``: each op's tensor operands and outputs, once each, the
  analogue of XLA's "bytes accessed" before fusion; views, waits and
  collectives move none, an ``empty`` writes none, and a gather (the
  embedding lookup) reads the rows it gathers and its indices, as XLA
  counts one.
- ``collective_bytes``, ``collective_counts``,
  ``collective_bytes_by_kind``: the operand bytes of each collective,
  c10d and functional, under the reference's five kind names
  (:data:`COLLECTIVES`; any other collective keeps its own name).
- memory: ``arg_bytes_per_dev`` is the inputs' local shards (with the
  scalars), ``out_bytes_per_dev`` the outputs', ``alias_bytes_per_dev``
  the outputs that are inputs updated in place (the cache, the
  parameters, the moments), ``peak_bytes_per_dev`` the most local
  storage alive at once during the step, inputs included, and
  ``tmp_bytes_per_dev`` = peak - (arg + out - alias), as the reference's
  peak = arg + out + tmp - alias.

A failure is recorded as ``ok: false`` with its trace (a fault in the
port, not a fallback); :func:`main` exits 1 when any cell failed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
import weakref
from collections import Counter

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.device import resolve_device
from repro_torch.launch import cells as C
from repro_torch.launch.roofline import HBM_BYTES

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
#: op-name prefixes of each kind (leading underscores dropped)
_KIND_PREFIXES = (("all-gather", ("allgather", "all_gather")),
                  ("all-reduce", ("allreduce", "all_reduce")),
                  ("reduce-scatter", ("reduce_scatter",)),
                  ("all-to-all", ("alltoall", "all_to_all")),
                  ("collective-permute", ("send", "recv", "permute")))
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional",
                          "_c10d_functional_autograd")
#: ops that read or write no tensor data
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "wait_tensor", "_local_scalar_dense"}
#: ops that read only the rows they gather from their first operand
_GATHERS = {"index", "embedding", "index_select", "gather"}
#: the reference's bytes of an int32 scalar input
SCALAR_BYTES = 4
#: gradient-accumulation microbatches of a train cell (the reference's)
MICROBATCH = 4


def start_fake_world(n: int) -> None:
    """A world of ``n`` ranks in this process, as rank 0, on
    ``torch.distributed``'s ``"fake"`` backend (collectives return at
    once and move nothing): the port's counterpart of the reference's
    ``--xla_force_host_platform_device_count``.  Call once a process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def collective_kind(func):
    """The reference's kind name of a collective op (its own name for a
    collective of no kind), or None for any other op."""
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    name = func._schema.name.split("::")[-1].lstrip("_")
    if name == "wait_tensor":
        return None
    for kind, prefixes in _KIND_PREFIXES:
        if name.startswith(prefixes):
            return kind
    return name.rstrip("_")


def _tensors(x):
    """Every tensor in a nest of lists, tuples and dicts (a Model counts
    as its tree)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif hasattr(x, "tree"):
        yield from _tensors(x.tree())
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _is_view(func) -> bool:
    """The op returns a view of an input (its schema says so)."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _op_key(func, args) -> str:
    """An op by name and its tensor operands' shapes."""
    name = func._schema.name.split("::")[-1]
    return name + " " + " @ ".join(
        "x".join(map(str, t.shape)) for t in _tensors(args))


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


class CostMode(TorchDispatchMode):
    """Counts the FLOPs, bytes, collectives and live storage of the ops
    run under it, as one rank runs them (the module's note).  Enter it,
    inside :meth:`hiding_dtensor_bookkeeping`, around one call;
    :meth:`hold` first registers the storage the call starts with."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop = flop_registry
        self.flops = 0
        self.flops_by_op = Counter()
        self.bytes = 0
        self.coll_bytes = Counter()
        self.coll_counts = Counter()
        self.live = self.peak = 0
        self._storages = {}     # id -> (weakref, nbytes)
        self._quiet = 0         # inside DTensor's sharding propagation
        self._patched = []

    # ---- live storage ----------------------------------------------------
    def hold(self, tensors) -> None:
        """Register the storages of ``tensors`` (local shards) as live."""
        for t in tensors:
            st = _local(t).untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            n = st.nbytes()
            ref = weakref.ref(st, lambda _, k=key: self._free(k))
            self._storages[key] = (ref, n)
            self.live += n
            self.peak = max(self.peak, self.live)

    def _free(self, key) -> None:
        ref_n = self._storages.pop(key, None)
        if ref_n is not None:
            self.live -= ref_n[1]

    # ---- DTensor's own bookkeeping is not the step's work ----------------
    def _hide(self, obj, name: str, real: bool = False) -> None:
        """Run ``obj.name`` uncounted for as long as the mode is entered
        (``real``: on real host tensors, outside the fake mode)."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        orig = getattr(obj, name)

        def hidden(*a, **k):
            self._quiet += 1
            try:
                if real:
                    with unset_fake_temporarily():
                        return orig(*a, **k)
                return orig(*a, **k)
            finally:
                self._quiet -= 1

        self._patched.append((obj, name, obj.__dict__.get(name)))
        setattr(obj, name, hidden)

    @contextlib.contextmanager
    def hiding_dtensor_bookkeeping(self):
        """DTensor's own work, uncounted while the block runs."""
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor import placement_types as PT

        prop = DTensor._op_dispatcher.sharding_propagator
        # the output's global shape, from the op run at global shapes
        self._hide(prop, "_propagate_tensor_meta_non_cached"
                   if hasattr(prop, "_propagate_tensor_meta_non_cached")
                   else "_propagate_tensor_meta")
        # a strided shard's indices, from arange and tolist, which a fake
        # tensor cannot give
        strided = getattr(PT, "_StridedShard", None)
        if strided is not None and "local_shard_size_and_offset" in \
                strided.__dict__:
            self._hide(strided, "local_shard_size_and_offset", real=True)
        try:
            yield self
        finally:
            for obj, name, before in reversed(self._patched):
                if before is None:
                    delattr(obj, name)
                else:
                    setattr(obj, name, before)
            self._patched = []

    # ---- counting --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # DTensor runs it as local ops on rank 0's shards, which come
            # back here
            return NotImplemented
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if not self._quiet and func._overloadpacket not in self._flop \
                and func is not torch.ops.prim.device.default:
            # a composite op (einsum, reshape, to) that reaches the mode
            # whole (under inference mode) is counted as the ops it
            # decomposes into, as autograd would have split it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        outs = list(_tensors(out))
        kind = collective_kind(func)
        if kind is not None:
            n = sum(_nbytes(t) for a, v in zip(func._schema.arguments, args)
                    if not a.name.startswith("out") for t in _tensors(v))
            self.coll_bytes[kind] += n
            self.coll_counts[kind] += 1
        else:
            f = self._flop.get(func._overloadpacket)
            if f is not None:
                n = f(*args, **kwargs, out_val=out)
                self.flops += n
                self.flops_by_op[_op_key(func, args)] += n
            # an op that makes no tensor (prim.device, sizes) moves none
            name = func._schema.name.split("::")[-1]
            if name in _GATHERS:
                # a gather reads the rows it gathers, not its whole source
                self.bytes += sum(_nbytes(t) for t in _tensors(args[1:])) \
                    + 2 * sum(_nbytes(t) for t in outs)
            elif outs and not _is_view(func) and name not in _NO_BYTES:
                self.bytes += self.op_bytes(args, kwargs, outs)
        self.hold(outs)
        return out

    @staticmethod
    def op_bytes(args, kwargs, outs) -> int:
        """One op's tensor operands and outputs, once each."""
        return (sum(_nbytes(t) for t in _tensors(args))
                + sum(_nbytes(t) for t in _tensors(kwargs))
                + sum(_nbytes(t) for t in outs))


def measure(fn, args, scalars: int = 0) -> dict:
    """Run ``fn(*args)`` once under a :class:`CostMode` (``args`` fake,
    placed) and return the record's cost and memory fields; ``scalars``
    int32 inputs the step takes as Python ints count in the arguments."""
    ins = list(_tensors(args))
    in_ids = {id(_local(t).untyped_storage()) for t in ins}
    arg_bytes = sum(_nbytes(_local(t)) for t in ins) + scalars * SCALAR_BYTES
    mode = CostMode()
    mode.hold(ins)
    with mode.hiding_dtensor_bookkeeping(), mode:
        out = fn(*args)
    outs, seen = [], set()
    for t in _tensors(out):
        st = _local(t).untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            outs.append((id(st) in in_ids, _nbytes(_local(t))))
    out_bytes = sum(n for _, n in outs)
    alias = sum(n for aliased, n in outs if aliased)
    return {
        "flops": float(mode.flops),
        "flops_by_op": {k: float(v) for k, v in sorted(
            mode.flops_by_op.items(), key=lambda kv: -kv[1])},
        "bytes": float(mode.bytes),
        "collective_bytes": float(sum(mode.coll_bytes.values())),
        "collective_counts": dict(mode.coll_counts),
        "collective_bytes_by_kind": {k: float(v)
                                     for k, v in mode.coll_bytes.items()},
        "arg_bytes_per_dev": arg_bytes,
        "out_bytes_per_dev": out_bytes,
        "tmp_bytes_per_dev": mode.peak - (arg_bytes + out_bytes - alias),
        "alias_bytes_per_dev": alias,
        "peak_bytes_per_dev": mode.peak,
    }


# ---------------------------------------------------------------------------
# the cell's step and its placed inputs
# ---------------------------------------------------------------------------
def _leaf(sds, spec, policy, dev):
    """A fake tensor of ``sds``: a DTensor laid out by ``spec`` under a
    policy, else a plain one on ``dev``."""
    if policy is None:
        return torch.empty(sds.shape, dtype=sds.dtype, device=dev)
    from torch.distributed.tensor import empty

    return empty(sds.shape, dtype=sds.dtype, device_mesh=policy.mesh,
                 placements=policy.placements(spec))


def _placed_tree(sds_tree, spec_tree, policy, dev):
    if isinstance(sds_tree, C.ShapeDtypeStruct):
        return _leaf(sds_tree, spec_tree, policy, dev)
    if isinstance(sds_tree, dict):
        return {k: _placed_tree(v, None if spec_tree is None
                                else spec_tree[k], policy, dev)
                for k, v in sds_tree.items()}
    return type(sds_tree)(
        _placed_tree(v, None if spec_tree is None else spec_tree[i],
                     policy, dev) for i, v in enumerate(sds_tree))


def build_cell(cfg: ModelConfig, shape: C.Shape, policy, dev, *,
               microbatch: int = MICROBATCH):
    """The cell's step and its inputs, placed (call under a fake mode).
    Returns (fn, args, scalars): ``fn(*args)`` runs one step, and
    ``scalars`` counts the int32 inputs given to it as ints.  ``policy``
    None is the one-device step; ``microbatch`` is a train step's."""
    from repro_torch.models import model as M
    from repro_torch.serve.serve_loop import (
        make_decode_step,
        make_prefill_step,
    )
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_loop import (
        act_shardings,
        batch_specs,
        make_train_step,
    )

    kind = shape.kind
    opt = OptConfig(eightbit=cfg.opt_8bit)
    specs = C.input_specs(cfg.name, shape.name, opt=opt, cfg=cfg,
                          shape=shape)
    pspecs = None if policy is None else M.param_specs(cfg, policy)
    model = M.Model(cfg, _placed_tree(specs[0], pspecs, policy, dev))
    if kind == "train":
        model.requires_grad_()
        opt_state = init_opt_state(model, opt)
        bspecs = None if policy is None else batch_specs(cfg, policy)
        batch = _placed_tree(specs[2], bspecs, policy, dev)
        step = make_train_step(cfg, opt, microbatch=microbatch, device=dev,
                               policy=policy)
        return (lambda p, s, b: step(p, s, b, 1)), (model, opt_state,
                                                     batch), 1
    if kind == "prefill":
        bspecs = (None if policy is None
                  else batch_specs(cfg, policy, train=False))
        batch = _placed_tree(specs[1], bspecs, policy, dev)
        if not cfg.causal:
            # encoder-only: "prefill" is a full forward (no cache)
            acts = None if policy is None else act_shardings(cfg, policy)

            def forward(p, b):
                with torch.no_grad():
                    return M.forward_train(cfg, p, b, shardings=acts)[0]

            return forward, (model, batch), 0
        return make_prefill_step(cfg, shape.seq_len, device=dev,
                                 policy=policy), (model, batch), 0
    # decode: one token against a full cache (cur_len = its length)
    cache = M.init_cache(cfg, shape.global_batch, shape.seq_len, device=dev,
                         policy=policy)
    tspec = None if policy is None else (
        (policy.dp, None) if not policy.seq_shard_data else (None, None))
    tokens = _placed_tree(specs[2], tspec, policy, dev)
    step = make_decode_step(cfg, device=dev, policy=policy)
    return ((lambda p, c, t: step(p, c, t, shape.seq_len)),
            (model, cache, tokens), 1)


def cell_policy(cfg: ModelConfig, shape: C.Shape, mesh, hbm_bytes: float):
    """The cell's sharding policy on ``mesh`` (None: one device)."""
    from repro_torch.models.sharding import make_policy

    if mesh is None:
        return None
    return make_policy(mesh, cfg, batch=shape.global_batch,
                       train=shape.kind == "train", hbm_bytes=hbm_bytes)


def trace_step(cfg: ModelConfig, shape: C.Shape, policy, dev, *,
               microbatch: int = MICROBATCH) -> dict:
    """One fake pass of the step: :func:`measure`'s fields."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fn, args, scalars = build_cell(cfg, shape, policy, dev,
                                       microbatch=microbatch)
        return measure(fn, args, scalars)


def at_groups(cfg: ModelConfig, groups: int) -> ModelConfig:
    """``cfg`` cut to ``groups`` of its repeating layer group."""
    return dataclasses.replace(cfg, num_layers=groups * len(cfg.group))


def _codecs(cfg: ModelConfig) -> list:
    """The moments' leaf paths: which leaves take the int8 codec, which
    depends on a stacked leaf's size and so on the depth (a smoke model's
    probe may differ from its full depth; then the step is traced
    whole)."""
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.tree import leaves_with_paths

    specs = C.opt_specs_abstract(C.params_specs_abstract(cfg),
                                 OptConfig(eightbit=cfg.opt_8bit))
    return [p for p, _ in leaves_with_paths(specs)]


#: the depths (groups) a composed step is traced at
PROBE_GROUPS = (2, 3)


def compose(two: dict, three: dict, groups: int) -> dict:
    """Every count of a step of ``groups`` groups from the steps of 2 and
    3: c(G) = c(2) + (G - 2) * (c(3) - c(2)) (per kind for the
    collectives).  From 2 groups on each group adds the same ops and the
    same live bytes at the peak; a 1-group step can peak elsewhere (a
    prefill's temporaries), so it is not a probe."""
    def lin(a, b):
        if isinstance(a, dict) or isinstance(b, dict):
            return {k: lin(a.get(k, 0), b.get(k, 0))
                    for k in sorted(set(a) | set(b))}
        return a + (groups - 2) * (b - a)

    return {k: lin(two[k], three[k]) for k in two}


def trace_cell(cfg: ModelConfig, shape: C.Shape, mesh, *,
               hbm_bytes: float = HBM_BYTES, device=None,
               microbatch: int = MICROBATCH):
    """The cell's counts on ``mesh`` (None: one device, unsharded).
    Returns (:func:`measure`'s fields, policy or None).

    Decode: one fake pass of the whole step.  Train and prefill: a whole
    step at full width takes minutes to trace (granite-3-8b's train step
    about six on one core: each of 40 layers runs four microbatches'
    forward, recompute and backward; its prefill three: each layer's
    blockwise attention is a loop of 272 tile pairs), so the step is
    traced at :data:`PROBE_GROUPS` under the full model's policy and
    composed (:func:`compose`): each group adds the same ops, its
    parameters, moments and cache the same bytes, and the rest
    (embedding, head, CE, the scalars) is the same at any depth.  Where a
    moment's codec changes with the depth (an int8 leaf at full depth
    that is float32 in a probe) the step is traced whole."""
    dev = resolve_device(device)
    policy = cell_policy(cfg, shape, mesh, hbm_bytes)
    if (shape.kind == "decode" or cfg.num_groups <= PROBE_GROUPS[1]
            or _codecs(at_groups(cfg, PROBE_GROUPS[0])) != _codecs(cfg)):
        return trace_step(cfg, shape, policy, dev,
                          microbatch=microbatch), policy
    two, three = (trace_step(at_groups(cfg, g), shape, policy, dev,
                             microbatch=microbatch) for g in PROBE_GROUPS)
    return compose(two, three, cfg.num_groups), policy


def run_cell(arch: str, shape_name: str, mesh, mesh_tag: str, *,
             smoke: bool = False, hbm_bytes: float = HBM_BYTES, device=None):
    t0 = time.perf_counter()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag}
    try:
        costs, policy = trace_cell(get_config(arch, smoke=smoke),
                                   C.SHAPES[shape_name], mesh,
                                   hbm_bytes=hbm_bytes, device=device)
        rec.update({
            "ok": True,
            "trace_s": round(time.perf_counter() - t0, 2),
            **costs,
            "tp": (policy.tp_a, policy.tp_b, policy.sp),
            "fsdp": policy.fsdp,
            "seq_shard": policy.seq_shard_data,
        })
    except Exception as e:  # a failure here is a fault in the port
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "trace": traceback.format_exc()[-2000:]})
    return rec


MESHES = {"single": ("1pod_16x16", False), "multi": ("2pod_2x16x16", True)}


def _children(argv, which) -> list:
    """``--multi-pod both``: each mesh in a child process of its own (one
    world a process); returns their records, cell by cell."""
    procs, outs = [], []
    for w in which:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        outs.append(path)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
             "--multi-pod", w, "--out", path]))
    rcs = [p.wait() for p in procs]
    recs = []
    try:
        for path in outs:
            with open(path) as f:
                recs.append(json.load(f))
    finally:
        for path in outs:
            os.unlink(path)
    if any(rc not in (0, 1) for rc in rcs):
        raise RuntimeError(f"a dry-run child failed: exit codes {rcs}")
    merged = [r for pair in zip(*recs) for r in pair]
    return merged


def _without(argv, flags) -> list:
    """``argv`` less each of ``flags`` and its value."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in flags:
            skip = True
        elif not a.startswith(tuple(f + "=" for f in flags)):
            out.append(a)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default="dryrun_results_torch.json")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors (default: the card)")
    ap.add_argument("--hbm-bytes", type=float, default=HBM_BYTES,
                    help="one rank's device memory for the sharding policy "
                         "(default: the H100's 80 GB; 16e9 is the "
                         "reference's TPU chip)")
    return ap.parse_args(argv)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    resolve_device(args.device)
    if args.multi_pod == "both":
        results = _children(_without(argv, ("--multi-pod", "--out")),
                            ("single", "multi"))
    else:
        from repro_torch.launch.mesh import make_production_mesh

        tag, multi = MESHES[args.multi_pod]
        start_fake_world(512 if multi else 256)
        mesh = make_production_mesh(multi_pod=multi, device=args.device)
        results = []
        for arch, sname, ok, why in C.all_cells():
            if args.arch and arch != args.arch:
                continue
            if args.shape and sname != args.shape:
                continue
            if not ok:
                results.append({"arch": arch, "shape": sname, "mesh": tag,
                                "ok": True, "skipped": True, "reason": why})
                print(f"SKIP  {arch:18s} {sname:12s} ({why})")
                continue
            rec = run_cell(arch, sname, mesh, tag,
                           hbm_bytes=args.hbm_bytes, device=args.device)
            results.append(rec)
            if rec["ok"]:
                print(
                    f"PASS  {arch:18s} {sname:12s} {tag:12s} "
                    f"trace={rec['trace_s']:6.1f}s "
                    f"flops/dev={rec['flops']:.3e} "
                    f"peak/dev={rec['peak_bytes_per_dev']/1e9:6.2f}GB "
                    f"coll={rec['collective_bytes']/1e9:8.3f}GB", flush=True)
            else:
                print(f"FAIL  {arch:18s} {sname:12s} {tag:12s} "
                      f"{rec['error']}", flush=True)
                if args.verbose:
                    print(rec.get("trace", ""))
        dist.destroy_process_group()
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    n_fail = sum(1 for r in results if not r.get("ok"))
    n_skip = sum(1 for r in results if r.get("skipped"))
    print(f"\n{len(results)} cells: {len(results)-n_fail-n_skip} passed, "
          f"{n_skip} skipped-by-design, {n_fail} FAILED -> {args.out}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
