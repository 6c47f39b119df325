"""Sharding policy: maps (arch config x mesh) to sharding specs and DTensor
placements.

The port's copy of `repro.models.sharding`.  Physical production mesh
axes: ("data", "model") = (16, 16); multi-pod adds a leading "pod".  Per
arch the "model" axis is *refined* into three logical sub-axes ("tp_a",
"tp_b", "sp"):

  tp     = tp_a * tp_b = largest divisor of |model| dividing num_heads
  tp_a   = gcd(kv_heads, tp)   -- KV heads shard here
  tp_b   = tp / tp_a           -- query groups shard here; KV is replicated
                                  across tp_b (Megatron-style GQA)
  sp     = |model| / tp        -- leftover; joins tp for feature-dim (MLP,
                                  vocab, expert) sharding

FSDP: when parameters (+ optimizer state) per rank would exceed half the
device memory, weights are also sharded over "data"; for serving, such
weights stay *stationary* instead (their output features take "data" too).

A policy is computable from axis sizes alone (:func:`make_policy` takes a
``DeviceMesh`` or a ``{name: size}`` mapping), so the production meshes'
policies are known without 256 or 512 ranks.  A spec is the reference's
``PartitionSpec`` as a tuple, one entry per tensor dim: ``None``, an axis
name, or a tuple of axis names, canonical as JAX makes them (:func:`P`),
so ``tuple(ref_spec) == port_spec`` holds entry for entry.  :func:`placements` turns a spec into DTensor placements
on the refined ``DeviceMesh``.

**Shard order.**  JAX shards a tensor dim named by a tuple of axes in the
tuple's order (the first axis is the major one); DTensor shards a dim
split over several mesh dims in mesh-dim order.  The two agree wherever
the tuple lists axes in mesh order, which every spec here does except the
weight-stationary ``wide = tp_full + ("data",)`` and ``f_wide`` specs:
the reference makes "data" the minor axis there, the port keeps the
mesh's order and makes it the major one.  The full tensors are the same;
the local shards differ, so compare full tensors.

The device memory is the card's (``torch.cuda.get_device_properties``),
or the host's for a CPU mesh; ``make_policy(hbm_bytes=)`` overrides it
(the reference assumes a 16 GB TPU chip, ``HBM_PER_CHIP``; pass 16e9 to
reproduce its decisions).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig

Spec = Tuple  # one entry per tensor dim: None | axis name | tuple of names

#: the logical sub-axes the "model" axis is refined into, in mesh order
MODEL_SUBAXES = ("tp_a", "tp_b", "sp")


def P(*entries) -> Spec:
    """A spec, canonical as JAX's ``PartitionSpec``: an entry that is a
    tuple of one axis becomes that axis's name, an empty one None."""
    out = []
    for e in entries:
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = None if not e else (e[0] if len(e) == 1 else e)
        out.append(e)
    return tuple(out)


def _largest_div(n: int, cap: int) -> int:
    """Largest divisor of ``cap`` (a power of two) that divides n."""
    d = cap
    while d > 1 and n % d:
        d //= 2
    return d


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    axes: Tuple[Tuple[str, int], ...]   # refined mesh (name, size), in order
    has_pod: bool
    tp_a: int
    tp_b: int
    sp: int
    fsdp: bool                          # shard params over "data" too
    seq_shard_data: bool = False        # shard sequence (not batch) over dp
    # serving a model that would need FSDP: keep the weights stationary by
    # sharding their output-feature dims over "data" as well
    weight_stationary: bool = False
    # the refined DeviceMesh (None for a policy computed from sizes alone)
    mesh: Optional[object] = dataclasses.field(default=None, compare=False,
                                               repr=False)

    # ---- axis tuples -----------------------------------------------------
    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.axes)

    @property
    def dp(self) -> Tuple[str, ...]:
        return ("pod", "data") if self.has_pod else ("data",)

    @property
    def dp_size(self) -> int:
        return math.prod(self.shape[a] for a in self.dp)

    @property
    def tp_full(self) -> Tuple[str, ...]:
        return MODEL_SUBAXES

    @property
    def tp_heads(self) -> Tuple[str, ...]:
        return ("tp_a", "tp_b")

    @property
    def model_size(self) -> int:
        return self.tp_a * self.tp_b * self.sp

    def describe(self) -> str:
        return (f"tp_a={self.tp_a} tp_b={self.tp_b} sp={self.sp} "
                f"fsdp={self.fsdp} weight_stationary="
                f"{self.weight_stationary} seq_shard_data="
                f"{self.seq_shard_data}")

    def _fs(self):
        """The FSDP axis (or None)."""
        return "data" if self.fsdp else None

    # ---- parameter specs ---------------------------------------------------
    def spec(self, role: str, cfg: ModelConfig) -> Spec:
        fs = self._fs()
        E_axes, F_axes = self._expert_axes(cfg)
        if self.weight_stationary:
            # big matrices: the feature dim takes the tp axes AND "data";
            # attention weights stay FSDP-style
            wide = tuple(self.tp_full) + ("data",)
            f_wide = (tuple(F_axes) if F_axes else ()) + ("data",)
            table = {
                "embed": (self.tp_full, None),
                "head": (None, wide),
                "frontend": (None, wide),
                "wq": (fs, self.tp_heads, None),
                "wkv": (fs, "tp_a", None),
                "wo": (self.tp_heads, None, fs),
                "wi": (None, wide),
                "wo_mlp": (wide, None),
                "router": (None, None),
                "expert_wi": (E_axes, None, f_wide),
                "expert_wo": (E_axes, f_wide, None),
                "ssm_in": (None, wide),
                "ssm_in_state": (None, self.tp_full),
                "ssm_dt": (None, self.tp_full),
                "ssm_conv": (None, None),
                "ssm_vec": (self.tp_full,),
                "ssm_out": (wide, None),
                "norm": (None,),
                "scalar": (),
            }
            if role not in table:
                raise KeyError(role)
            return P(*table[role])
        table = {
            "embed": (self.tp_full, fs),            # (V, D)
            "head": (fs, self.tp_full),             # (D, V)
            "frontend": (fs, self.tp_full),         # (D_front, D)
            "wq": (fs, self.tp_heads, None),        # (D, H, hd)
            "wkv": (fs, "tp_a", None),              # (D, K, hd)
            "wo": (self.tp_heads, None, fs),        # (H, hd, D)
            "wi": (fs, self.tp_full),               # (D, F)
            "wo_mlp": (self.tp_full, fs),           # (F, D)
            "router": (fs, None),                   # (D, E)
            "expert_wi": (E_axes, fs, F_axes),      # (E, D, F)
            "expert_wo": (E_axes, F_axes, fs),      # (E, F, D)
            "ssm_in": (fs, self.tp_full),           # (D, d_inner)
            "ssm_in_state": (fs, self.tp_full),     # (D, ssm_state)
            "ssm_dt": (fs, self.tp_full),           # (D, heads)
            "ssm_conv": (None, self.tp_full),       # (w, channels)
            "ssm_vec": (self.tp_full,),             # (heads,)
            "ssm_out": (self.tp_full, fs),          # (d_inner, D)
            "norm": (None,),
            "scalar": (),
        }
        if role not in table:
            raise KeyError(role)
        return P(*table[role])

    def expert_axes(self, cfg: ModelConfig):
        """(expert-dim axes, leftover feature-dim axes)."""
        return self._expert_axes(cfg)

    def _expert_axes(self, cfg: ModelConfig):
        """Split the tp axes between the expert dim and the FFN features."""
        if not cfg.num_experts:
            return None, None
        e_axes, rem = [], []
        e = cfg.num_experts
        prod = 1
        for name, size in (("tp_a", self.tp_a), ("tp_b", self.tp_b),
                           ("sp", self.sp)):
            if size == 1:
                continue
            if e % (prod * size) == 0:
                e_axes.append(name)
                prod *= size
            else:
                rem.append(name)
        return (tuple(e_axes) or None), (tuple(rem) or None)

    # ---- activation specs --------------------------------------------------
    def act(self, *dims) -> Spec:
        """An activation's spec from its dims' entries (the reference's)."""
        return P(*dims)

    def batch_spec(self) -> Spec:
        """(B, T, ...) activations: batch over dp (or seq over dp)."""
        if self.seq_shard_data:
            return P(None, self.dp)
        return P(self.dp, None)

    def cache_spec(self) -> Spec:
        """KV cache (B, S, K, hd)."""
        if self.seq_shard_data:
            return P(None, self.dp, "tp_a", None)
        return P(self.dp, None, "tp_a", None)

    def ssm_cache_spec(self) -> Spec:
        """SSM state (B, heads, hd, state): heads over tp."""
        if self.seq_shard_data:
            return P(None, self.tp_full, None, None)
        return P(self.dp, self.tp_full, None, None)

    # ---- DTensor -----------------------------------------------------------
    @property
    def mesh_axes(self) -> Tuple[str, ...]:
        """The dims of the refined ``DeviceMesh``: the axes of size > 1
        (or the first axis, for a world of one)."""
        return mesh_axes(self.axes)

    def placements(self, spec: Spec) -> tuple:
        """The spec as DTensor placements on this policy's refined mesh
        (an axis of size 1 splits nothing and is not a mesh dim)."""
        return placements(spec, self.mesh_axes, self.shape)

    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 on an axis of size 1)."""
        if self.shape[axis] == 1:
            return 0
        return self.mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group along ``axis`` (size > 1)."""
        return self.mesh.get_group(axis)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A DTensor layout: the port's ``NamedSharding``."""
    mesh: object
    placements: tuple


def is_spec(x) -> bool:
    """A spec: a tuple of None, axis names and tuples of axis names."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) or (isinstance(e, tuple) and all(
            isinstance(a, str) for a in e)) for e in x)


def named_shardings(policy: ShardingPolicy, specs):
    """A tree of specs -> the same tree of :class:`Sharding` on the
    policy's mesh (the reference's ``_shard(mesh, tree_specs)``)."""
    if is_spec(specs):
        return Sharding(policy.mesh, policy.placements(specs))
    if isinstance(specs, dict):
        return {k: named_shardings(policy, v) for k, v in specs.items()}
    return type(specs)(named_shardings(policy, v) for v in specs)


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh_dim_names: Sequence[str],
               sizes: Optional[Mapping[str, int]] = None) -> tuple:
    """One placement per mesh dim: ``Shard(i)`` where tensor dim ``i``'s
    entry names that mesh dim, else ``Replicate()`` (also for a dim whose
    size in ``sizes`` is 1).  A tensor dim named by several axes is split
    in mesh-dim order (see the module's note)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = sizes or {}
    owner: Dict[str, int] = {}
    for i, entry in enumerate(spec):
        for a in _axes_of(entry):
            if a in owner:
                raise ValueError(f"axis {a!r} used twice in {spec}")
            if a not in mesh_dim_names and sizes.get(a, 2) > 1:
                raise ValueError(f"spec {spec} names {a!r}, not an axis of "
                                 f"the mesh {tuple(mesh_dim_names)}")
            owner[a] = i
    return tuple(Shard(owner[n]) if n in owner and sizes.get(n, 2) > 1
                 else Replicate() for n in mesh_dim_names)


def shard_extent(shape: Sequence[int], mesh_sizes: Sequence[int],
                 coord: Sequence[int], pls) -> Tuple[tuple, tuple]:
    """(local shape, global offset) of the shard at mesh coordinate
    ``coord`` of a tensor of ``shape`` laid out by ``pls`` (one placement
    per mesh dim), in plain Python: each ``Shard(d)`` in mesh-dim order
    splits what is left of dim d into ``torch.chunk``'s pieces (ceil-sized,
    the last ones short or empty), as DTensor splits it.  Unlike torch's
    ``compute_local_shape_and_global_offset`` it reads no tensor, so it
    runs under fake tensors."""
    from torch.distributed.tensor import Shard

    local, off = list(shape), [0] * len(shape)
    for size, c, p in zip(mesh_sizes, coord, pls):
        if isinstance(p, Shard):
            n = local[p.dim]
            lo = min(c * -(-n // size), n)
            local[p.dim] = min(lo + -(-n // size), n) - lo
            off[p.dim] += lo
    # an empty shard sits at the end of its dim, as torch places it
    off = [shape[d] if local[d] == 0 else o for d, o in enumerate(off)]
    return tuple(local), tuple(off)


MeshLike = Union["torch.distributed.device_mesh.DeviceMesh",
                 Mapping[str, int], Sequence[Tuple[str, int]]]


def _mesh_axes(mesh: MeshLike) -> Tuple[Tuple[str, int], ...]:
    if hasattr(mesh, "mesh_dim_names"):
        return tuple(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))
    items = mesh.items() if isinstance(mesh, Mapping) else mesh
    return tuple((str(n), int(s)) for n, s in items)


def refine_axes(axes, cfg: ModelConfig):
    """Split the "model" axis of ``axes`` ((name, size) pairs) into
    ("tp_a", "tp_b", "sp").  Returns (refined axes, tp_a, tp_b, sp)."""
    axes = tuple(axes)
    names = [n for n, _ in axes]
    if "model" not in names:
        raise ValueError(f"mesh {names} lacks a 'model' axis")
    model = dict(axes)["model"]
    heads = cfg.num_heads or cfg.ssm_heads
    tp = _largest_div(heads, model)
    tp_a = math.gcd(cfg.kv_heads, tp) if cfg.kv_heads else tp
    while tp % tp_a:
        tp_a //= 2
    tp_b = tp // tp_a
    sp = model // tp
    if cfg.num_heads and cfg.kv_heads:
        g = cfg.num_heads // cfg.kv_heads
        assert g % tp_b == 0, (cfg.name, g, tp_b)
    refined = []
    for n, s in axes:
        if n == "model":
            refined += [("tp_a", tp_a), ("tp_b", tp_b), ("sp", sp)]
        else:
            refined.append((n, s))
    return tuple(refined), tp_a, tp_b, sp


def mesh_axes(axes) -> Tuple[str, ...]:
    """The axes of size > 1 (or the first axis, when all are 1)."""
    names = tuple(n for n, s in axes if s > 1)
    return names or (axes[0][0],)


def refine_mesh(mesh, cfg: ModelConfig):
    """Split a ``DeviceMesh``'s "model" dim into ("tp_a", "tp_b", "sp"):
    a new ``DeviceMesh`` over the same ranks in the same order, whose dims
    are the refined axes of size > 1 (DTensor's sharding propagation
    grows with the mesh's dims, and an axis of size 1 splits nothing).
    Every rank of ``mesh`` must call this, as every rank builds a mesh's
    groups.  Returns (refined mesh, tp_a, tp_b, sp)."""
    from torch.distributed.device_mesh import DeviceMesh

    refined, tp_a, tp_b, sp = refine_axes(_mesh_axes(mesh), cfg)
    keep = mesh_axes(refined)
    sizes = dict(refined)
    ranks = mesh.mesh.reshape([sizes[n] for n in keep])
    new = DeviceMesh(mesh.device_type, ranks, mesh_dim_names=keep)
    return new, tp_a, tp_b, sp


def device_memory_bytes(mesh) -> float:
    """The memory of one rank's device: the card's, or the host's for a
    CPU mesh (or a mesh given by sizes alone)."""
    dev_type = getattr(mesh, "device_type", "cpu")
    if dev_type == "cuda":
        return float(torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory)
    return float(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def make_policy(mesh: MeshLike, cfg: ModelConfig, *, batch: int,
                train: bool, seq_len: int = 0,
                hbm_bytes: Optional[float] = None) -> ShardingPolicy:
    """The policy of ``cfg`` on ``mesh`` (a ``DeviceMesh``: the policy
    then carries the refined mesh; or axis sizes: a policy without one).
    ``hbm_bytes`` is one rank's device memory (default: the device's, see
    :func:`device_memory_bytes`)."""
    axes = _mesh_axes(mesh)
    refined, tp_a, tp_b, sp = refine_axes(axes, cfg)
    rmesh = None
    if hasattr(mesh, "mesh_dim_names"):
        rmesh, _, _, _ = refine_mesh(mesh, cfg)
    shape = dict(refined)
    has_pod = "pod" in shape
    dp_size = shape["data"] * (shape["pod"] if has_pod else 1)
    model = tp_a * tp_b * sp
    if hbm_bytes is None:
        hbm_bytes = device_memory_bytes(mesh)

    # FSDP decision: params (+ moments + grads) per rank under model-only
    # sharding; engaged only when that would exceed half the memory
    bytes_per_param = 4 if cfg.param_dtype == "float32" else 2
    if train:
        bytes_per_param += (2.1 if cfg.opt_8bit else 8)      # moments
        bytes_per_param += 4 if cfg.param_dtype == "float32" else 2  # grads
    per_rank = cfg.param_count() * bytes_per_param / model
    fsdp = per_rank > 0.5 * hbm_bytes

    # decode: weights that would need FSDP stay stationary instead
    # (re-gathering them for every token is the worst use of the links)
    weight_stationary = (not train) and fsdp
    if weight_stationary:
        fsdp = False

    seq_shard = batch % dp_size != 0
    if seq_shard and batch != 1:
        raise ValueError(f"batch {batch} not shardable over dp={dp_size}")
    return ShardingPolicy(
        axes=refined, has_pod=has_pod, tp_a=tp_a, tp_b=tp_b, sp=sp,
        fsdp=fsdp, seq_shard_data=seq_shard,
        weight_stationary=weight_stationary, mesh=rmesh,
    )


def run_local(fn, policy, ins, out_pls, split=()):
    """The port's ``local_map``: each (tensor, placements) of ``ins`` is
    redistributed to the placements (None: passed as it is) and its local
    shard given to ``fn``; ``fn``'s outputs are wrapped as DTensors with
    ``out_pls``.  ``split`` names the mesh axes across which the body
    splits its work (different heads or tokens per rank): a local
    gradient of an input replicated along such an axis is a partial sum
    (``Partial``); along any other axis the body repeats its work and the
    gradient is whole."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = policy.mesh
    locs = []
    for t, pl in ins:
        if pl is None or not isinstance(t, DTensor):
            locs.append(t)
            continue
        t = t if tuple(t.placements) == tuple(pl) else t.redistribute(mesh, pl)
        gp = tuple(Partial() if isinstance(p, Replicate) and n in split
                   else p for n, p in zip(policy.mesh_axes, pl))
        locs.append(t.to_local(grad_placements=gp))
    outs = fn(*locs)
    return tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                 for o, pl in zip(outs, out_pls))
