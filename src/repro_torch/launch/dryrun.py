"""Multi-pod dry run: trace every (architecture × input shape) cell's step
on the production meshes, at full width and zero allocation, and record
one rank's work, collectives and memory.

    PYTHONPATH=src python -m repro_torch.launch.dryrun              # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-2.7b \\
        --shape long_500k --multi-pod both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
        --out dryrun_results_torch.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b \\
        --shape train_4k --multi-pod single --whole    # no probes

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
output's shape, and, where no rule of its own covers the op (torch
2.11's softplus), its decomposition on meta tensors, is not counted: it
runs the first time a process meets an op and is cached, so a count that
took it in would differ between a process's first trace and its later
ones.

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
  peak = arg + out + tmp - alias.  ``peak_region`` names the region of
  the step where the peak falls (:func:`region_name`), and ``peak_from``
  says whether the step was traced ``"whole"`` (``whole_why`` says why)
  or ``"composed"`` from probes (:func:`trace_cell`,
  :func:`compose_regions`).

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
        self.regions = {}       # region label -> the most live in it
        self.levels = {}        # once-only region label -> its live counts
        self._storages = {}     # id -> (weakref, nbytes)
        self._quiet = 0         # inside DTensor's sharding propagation
        self._patched = []
        self._open = None       # the open region's opening mark
        self._open_max = 0
        self._open_levels = []  # the open region's live count at each op
        self._passes = 0        # layer calls outside a backward
        self._mb = 0            # the microbatch of the last of them

    # ---- live storage ----------------------------------------------------
    def hold(self, tensors) -> None:
        """Register the storages of ``tensors`` (local shards) as live."""
        before = self.live
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
            self._open_max = max(self._open_max, self.live)
        if self.live > before:
            self._open_levels.append(self.live)

    def _free(self, key) -> None:
        ref_n = self._storages.pop(key, None)
        if ref_n is not None:
            self.live -= ref_n[1]

    # ---- the peak region by region -------------------------------------
    def mark(self, event) -> None:
        """Close the open region at ``event`` and open the next one at the
        live bytes of this moment (``event`` None closes the last)."""
        if self._open is not None:
            label = _region_label(self._open, event)
            self.regions[label] = max(self.regions.get(label, 0),
                                      self._open_max)
            if label[0] != "layer":
                self.levels.setdefault(label, []).extend(self._open_levels)
        self._open, self._open_max = event, self.live
        self._open_levels = [self.live]

    def _hook(self, event, only_after=None):
        """A gradient hook that marks ``event`` (where ``only_after`` is
        given, only while the open region's mark starts with it) and
        leaves the gradient as it is."""
        def hook(_):
            if only_after is None or self._open[:len(only_after)] == \
                    only_after:
                self.mark(event)

        return hook

    def marking_regions(self) -> None:
        """Mark the step's regions (:func:`_region_label`) while
        :meth:`hiding_dtensor_bookkeeping` is entered, by wrapping the
        port's functions at fixed points of the step and registering
        gradient hooks.  The wrappers and hooks read the live count and
        add no op.

        - ``_block_apply`` called outside a backward (remat's recompute
          runs inside the layer's backward region): its call's ordinal
          gives the microbatch and the layer's place in the pass, g *
          len(cfg.group) + j.  The forward region opens at the call and
          closes at its return; the backward region opens where the
          gradient of the layer's output arrives.
        - the gradients of the group-0 slices of the stacked leaves: the
          first to arrive after the pass's last layer (autograd runs the
          layers' nodes before the slices' stack) opens the stacking;
          the gradient of the pass's input opens the embedding's
          backward.
        - ``_embed_inputs``, ``init_cache``, ``torch.autograd.grad``'s
          return, and each leaf's first ``_sqsum`` (the gradients' norm)
          and ``_leaf_core`` (AdamW; the runs of a chunked leaf share its
          storage, so they share the region)."""
        from repro_torch.models import model as M
        from repro_torch.train import optimizer as O

        block, grad = M._block_apply, torch.autograd.grad

        def marked_block(cfg, spec, p, x, *a, **k):
            if torch._C._current_autograd_node() is not None:
                return block(cfg, spec, p, x, *a, **k)   # remat's recompute
            n, L, J = self._passes, cfg.num_layers, len(cfg.group)
            self._passes += 1
            self._mb = mb = n // L
            place = (mb, n % L, J)
            if n % L < J:
                for t in p.values():
                    if t.requires_grad:
                        t.register_hook(self._hook(("stack", mb),
                                                   ("enter", "bwd", mb)))
            if n % L == 0 and x.requires_grad:
                x.register_hook(self._hook(("exit", "bwd", *place)))
            self.mark(("enter", "fwd", *place))
            out = block(cfg, spec, p, x, *a, **k)
            if out[0].requires_grad:
                out[0].register_hook(self._hook(("enter", "bwd", *place)))
            self.mark(("exit", "fwd", *place))
            return out

        def marked_grad(*a, **k):
            out = grad(*a, **k)
            self.mark(("grads", self._mb))
            return out

        def on_entry(obj, name, event_of):
            orig = getattr(obj, name)

            def marked(*a, **k):
                event = event_of(*a, **k)
                if event is not None:
                    self.mark(event)
                return orig(*a, **k)

            self._patch(obj, name, marked)

        def per_leaf(kind):
            last, n = None, 0

            def event_of(x, *a, **k):
                nonlocal last, n
                # one leaf's runs come one after another
                key = id(x.untyped_storage())
                if key == last:
                    return None
                last, n = key, n + 1
                return (kind, n - 1)

            return event_of

        self._patch(M, "_block_apply", marked_block)
        on_entry(M, "_embed_inputs", lambda cfg, *a, **k: (
            "embed", self._passes // cfg.num_layers))
        on_entry(M, "init_cache", lambda *a, **k: ("cache",))
        self._patch(torch.autograd, "grad", marked_grad)
        on_entry(O, "_sqsum", per_leaf("norm"))
        on_entry(O, "_leaf_core", per_leaf("leaf"))

    # ---- DTensor's own bookkeeping is not the step's work ----------------
    def _patch(self, obj, name: str, new) -> None:
        """``obj.name = new`` for as long as
        :meth:`hiding_dtensor_bookkeeping` is entered."""
        self._patched.append((obj, name, obj.__dict__.get(name)))
        setattr(obj, name, new)

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

        self._patch(obj, name, hidden)

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
        # the output's placements; where no rule covers the op it is
        # propagated through the op's decomposition, run on meta tensors at
        # global shapes over a fake mesh that DTensor makes (and keeps) then
        for name in ("propagate_op_sharding",
                     "propagate_op_sharding_non_cached"):
            if hasattr(prop, name):
                self._hide(prop, name)
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


#: the regions that occur once in a step, each named by its mark:
#: ``("start",)`` the step's start; ``("embed", mb)`` microbatch mb's
#: embedding; ``("cache",)`` a prefill's cache; ``("stack", mb)`` the
#: stacked leaves' gradients made whole from their groups' slices;
#: ``("grads", mb)`` what follows the backward (the gradients laid out as
#: their parameters, their sum over the microbatches); ``("norm", n)``
#: and ``("leaf", n)`` the n-th leaf's part of the gradients' norm and of
#: AdamW
_ONCE = {"start": "start", "embed": "mb {} embedding", "cache": "cache",
         "stack": "mb {} gradient stacks", "grads": "mb {} gradients",
         "norm": "norm leaf {}", "leaf": "adamw leaf {}"}


def _region_label(opened, closed):
    """The label of the region opened at mark ``opened`` and closed at
    mark ``closed`` (None: the step's end): a once-only mark's own (see
    :data:`_ONCE`); ``("layer", mb, phase, j, g)`` for layer j of group g
    in microbatch mb's ``"fwd"`` or ``"bwd"`` pass, with what follows it
    up to the next layer's mark; or ``("turn", mb, phase)`` for what
    follows the pass's last layer up to the next mark: after the forward
    the head and the loss, after the backward the embedding's
    backward."""
    if opened[0] in _ONCE:
        return opened
    edge, phase, mb, place, J = opened
    nxt = place + (1 if phase == "fwd" else -1)
    if edge == "enter" or (closed is not None
                           and closed[:4] == ("enter", phase, mb, nxt)):
        return ("layer", mb, phase, place % J, place // J)
    return ("turn", mb, phase)


def region_name(label) -> str:
    """A region's label as a record writes it (``"mb 3 bwd group 39
    layer 0"``)."""
    if label[0] in _ONCE:
        return _ONCE[label[0]].format(*label[1:])
    if label[0] == "turn":
        return f"mb {label[1]} " + ("head and loss" if label[2] == "fwd"
                                    else "embedding backward")
    _, mb, phase, j, g = label
    return f"mb {mb} {phase} group {g} layer {j}"


def measure(fn, args, scalars: int = 0) -> dict:
    """Run ``fn(*args)`` once under a :class:`CostMode` (``args`` fake,
    placed) and return the record's cost and memory fields; ``scalars``
    int32 inputs the step takes as Python ints count in the arguments.
    ``regions`` lists each region's label and peak in the order the
    regions opened, and ``peak_region`` names the one that set the
    peak."""
    ins = list(_tensors(args))
    in_ids = {id(_local(t).untyped_storage()) for t in ins}
    arg_bytes = sum(_nbytes(_local(t)) for t in ins) + scalars * SCALAR_BYTES
    mode = CostMode()
    mode.hold(ins)
    with mode.hiding_dtensor_bookkeeping(), mode:
        mode.marking_regions()
        mode.mark(("start",))
        out = fn(*args)
        mode.mark(None)
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
        "peak_region": region_name(max(mode.regions, key=mode.regions.get)),
        "regions": [[list(k), v, mode.levels.get(k)]
                    for k, v in mode.regions.items()],
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


def _chunking(cfg: ModelConfig, policy) -> list:
    """Which parameter leaves AdamW updates in runs of rows (``_chunked``
    on rank 0's local shard): a stacked leaf's size grows with the depth,
    so a leaf whole in a probe may be chunked at full depth (then the step
    is traced whole)."""
    from repro_torch.models import model as M
    from repro_torch.models.sharding import shard_extent
    from repro_torch.train.optimizer import _chunked
    from repro_torch.train.tree import leaves_with_paths, subtree

    specs = None if policy is None else M.param_specs(cfg, policy)
    out = []
    for path, sds in leaves_with_paths(C.params_specs_abstract(cfg)):
        shape = tuple(sds.shape)
        if specs is not None:
            sizes = [policy.shape[a] for a in policy.mesh_axes]
            shape = shard_extent(shape, sizes, [0] * len(sizes),
                                 policy.placements(subtree(specs, path)))[0]
        out.append(_chunked(torch.empty(shape, device="meta")))
    return out


#: the depths (groups) a composed step is traced at
PROBE_GROUPS = (2, 3)
#: the fields a record's peak sets
_PEAK_FIELDS = ("peak_bytes_per_dev", "tmp_bytes_per_dev", "peak_region",
                "regions")


class ProbesDoNotFit(ValueError):
    """The probes' regions do not fit :func:`compose_regions`'s rule: the
    step is traced whole instead."""


def compose_regions(two: dict, three: dict, groups: int) -> dict:
    """Each region's peak in a step of ``groups`` groups (label -> bytes),
    from the regions (:func:`measure`'s ``regions``) of its 2- and
    3-group probes.

    A region that occurs once in the step (:data:`_ONCE`, a turn) runs
    the same ops at any depth, and the live count after each of them is
    a line in the depth G: the two probes give each line, and the region
    peaks at the largest of them (the line through the region's two
    peaks where the probes run it in a different number of ops: AdamW's
    runs of a chunked leaf, one a group).  A layer's region (its
    microbatch, pass and place j in the group fixed) repeats in every
    group g and, from g = 1 on, peaks at ``a + b·g + c·G``: b is what the
    groups before it leave alive (in the forward) or what those after it
    have freed and given gradients (in the backward), c what every group
    adds (parameters, moments, gradients).  Group 0 peaks at ``a0 +
    c·G``: no group comes before it (no earlier layer's aux loss is held
    there, and the aux loss's sum starts there, 4 bytes either way).  The
    3-group probe gives b, both probes give c at g = 0 and at g = 1, and
    the two must agree.

    Raises :class:`ProbesDoNotFit` where the probes do not fit this rule:
    a region in one probe and not in the other, a c that disagrees
    between groups 0 and 1, or a region that holds less at 3 groups than
    at 2."""
    def split(rec):
        once, layers = {}, {}
        for k, peak, levels in rec["regions"]:
            if k[0] == "layer":
                layers.setdefault(tuple(k[1:4]), {})[k[4]] = peak
            else:
                once[tuple(k)] = (peak, levels)
        return once, layers

    def line(a, b):
        return a + (groups - 2) * (b - a)

    (once2, lay2), (once3, lay3) = split(two), split(three)
    if set(once2) != set(once3) or set(lay2) != set(lay3):
        differ = set(once2) ^ set(once3) | set(lay2) ^ set(lay3)
        raise ProbesDoNotFit(f"the probes' regions differ: "
                             f"{sorted(differ, key=str)[:4]}")
    out = {}
    for k, (v2, l2) in once2.items():
        v3, l3 = once3[k]
        if v3 < v2:
            raise ProbesDoNotFit(f"{region_name(k)} holds {v3} bytes at 3 "
                                 f"groups, {v2} at 2")
        out[k] = (max(map(line, l2, l3)) if len(l2) == len(l3)
                  else line(v2, v3))
    for k, v2 in lay2.items():
        v3, name = lay3[k], region_name(("layer", *k, "g"))
        if sorted(v2) != [0, 1] or sorted(v3) != [0, 1, 2]:
            raise ProbesDoNotFit(f"{name}: groups {sorted(v2)} and "
                                 f"{sorted(v3)}")
        if v3[0] - v2[0] != v3[1] - v2[1]:
            raise ProbesDoNotFit(f"{name}: a group adds {v3[0] - v2[0]} "
                                 f"bytes at group 0, {v3[1] - v2[1]} at 1")
        if v3[0] < v2[0]:
            raise ProbesDoNotFit(f"{name} holds {v3[0]} bytes at 3 groups, "
                                 f"{v2[0]} at 2")
        for g in range(groups):
            out[("layer", *k, g)] = (line(v2[min(g, 1)], v3[min(g, 1)])
                                     + max(g - 1, 0) * (v3[2] - v3[1]))
    return out


def compose(two: dict, three: dict, groups: int) -> dict:
    """Every field of a step of ``groups`` groups from the steps of 2 and
    3.  The counts (FLOPs, bytes, collectives, the inputs' and outputs'
    bytes) are sums over the groups: c(G) = c(2) + (G - 2) * (c(3) -
    c(2)) (per kind for the collectives).  The peak is a maximum, not a
    sum: it is the largest of :func:`compose_regions`, which raises
    :class:`ProbesDoNotFit` where the probes do not fit its rule.  A
    1-group step can peak elsewhere (a prefill's temporaries), so it is
    not a probe."""
    def lin(a, b):
        if isinstance(a, dict) or isinstance(b, dict):
            return {k: lin(a.get(k, 0), b.get(k, 0))
                    for k in sorted(set(a) | set(b))}
        return a + (groups - 2) * (b - a)

    regions = compose_regions(two, three, groups)
    label = max(regions, key=regions.get)
    peak = regions[label]
    out = {k: lin(two[k], three[k]) for k in two if k not in _PEAK_FIELDS}
    out["peak_bytes_per_dev"] = peak
    out["tmp_bytes_per_dev"] = peak - (out["arg_bytes_per_dev"]
                                       + out["out_bytes_per_dev"]
                                       - out["alias_bytes_per_dev"])
    out["peak_from"] = "composed"
    out["peak_region"] = region_name(label)
    return out


def trace_cell(cfg: ModelConfig, shape: C.Shape, mesh, *,
               hbm_bytes: float = HBM_BYTES, device=None,
               microbatch: int = MICROBATCH, whole: bool = False):
    """The cell's counts on ``mesh`` (None: one device, unsharded).
    Returns (:func:`measure`'s fields less ``regions``, with
    ``peak_from`` "composed" or "whole" and, for a whole trace,
    ``whole_why``; policy or None).

    Decode: one fake pass of the whole step.  Train and prefill: a whole
    step at full width takes minutes to trace (granite-3-8b's train step
    about six on one core: each of 40 layers runs four microbatches'
    forward, recompute and backward; its prefill three: each layer's
    blockwise attention is a loop of 272 tile pairs), so the step is
    traced at :data:`PROBE_GROUPS` under the full model's policy and
    composed (:func:`compose`): each group adds the same ops, its
    parameters, moments and cache the same bytes, and the rest
    (embedding, head, CE, the scalars) is the same at any depth.  The
    step is traced whole where a moment's codec or a leaf's chunking in
    AdamW changes with the depth (an int8 leaf at full depth that is
    float32 in a probe; a leaf updated in runs of rows at full depth and
    whole in a probe) or where the probes' regions do not fit
    :func:`compose_regions`'s rule, and where ``whole`` asks for it: a
    cell that composes then also records ``composed``, its composed peak
    and region and how many regions compose to other peaks than the whole
    trace's."""
    dev = resolve_device(device)
    policy = cell_policy(cfg, shape, mesh, hbm_bytes)
    probe = at_groups(cfg, PROBE_GROUPS[0])
    why = composed = None
    if shape.kind == "decode":
        why = "a decode step"
    elif cfg.num_groups <= PROBE_GROUPS[1]:
        why = f"{cfg.num_groups} groups"
    elif _codecs(probe) != _codecs(cfg):
        why = "a moment's codec changes with the depth"
    elif shape.kind == "train" and (_chunking(probe, policy)
                                    != _chunking(cfg, policy)):
        why = "a leaf's chunking in AdamW changes with the depth"
    else:
        two, three = (trace_step(at_groups(cfg, g), shape, policy, dev,
                                 microbatch=microbatch) for g in PROBE_GROUPS)
        try:
            composed = compose(two, three, cfg.num_groups)
        except ProbesDoNotFit as e:
            why = f"the probes do not fit: {e}"
    if composed is not None and not whole:
        return composed, policy
    rec = trace_step(cfg, shape, policy, dev, microbatch=microbatch)
    traced = {tuple(k): v for k, v, _ in rec.pop("regions")}
    rec.update(peak_from="whole", whole_why=why or "asked for")
    if composed is not None:
        # the composed record held against the whole trace, region by
        # region
        regions = compose_regions(two, three, cfg.num_groups)
        off = [region_name(k) for k in {**traced, **regions}
               if traced.get(k) != regions.get(k)]
        rec["composed"] = {
            k: composed[k] for k in ("peak_bytes_per_dev", "peak_region")}
        rec["composed"].update(regions=len(traced), regions_off=len(off),
                               first_off=off[:8])
    return rec, policy


def run_cell(arch: str, shape_name: str, mesh, mesh_tag: str, *,
             smoke: bool = False, hbm_bytes: float = HBM_BYTES, device=None,
             whole: bool = False):
    t0 = time.perf_counter()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag}
    try:
        costs, policy = trace_cell(get_config(arch, smoke=smoke),
                                   C.SHAPES[shape_name], mesh,
                                   hbm_bytes=hbm_bytes, device=device,
                                   whole=whole)
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
    ap.add_argument("--whole", action="store_true",
                    help="trace every step whole, not from probes (minutes "
                         "a cell; checks a composed record)")
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
                           hbm_bytes=args.hbm_bytes, device=args.device,
                           whole=args.whole)
            results.append(rec)
            if rec["ok"]:
                held = "" if "composed" not in rec else (
                    " | composed {peak_bytes_per_dev}, {regions_off} of "
                    "{regions} regions off".format(**rec["composed"]))
                print(
                    f"PASS  {arch:18s} {sname:12s} {tag:12s} "
                    f"trace={rec['trace_s']:6.1f}s "
                    f"flops/dev={rec['flops']:.3e} "
                    f"peak/dev={rec['peak_bytes_per_dev']/1e9:6.2f}GB "
                    f"({rec['peak_from']}, {rec['peak_region']}{held}) "
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
