"""AdamW with optional 8-bit (int8, per-row absmax) first/second moments.

The port's copy of `repro.train.optimizer`.  8-bit moments cut optimizer
memory from 8 bytes a parameter to 2 + ~0.02.  Quantization is per row
(last axis) absmax, symmetric for m; v >= 0 is stored as sqrt(v) scaled.

The state is a tree shaped like the parameters' (``Model.tree()``) with a
dict at each leaf: ``{"m", "v"}`` (float32) or ``{"m_q", "m_s", "v_q",
"v_s"}``.  :func:`adamw_update` writes the parameters and the state in
place (the reference donates them), in the reference's order of float32
operations; scalars that depend only on the step (lr, bias corrections)
are computed on the host in float32 as the reference computes them.
Leaves above 2**27 elements with a leading axis are updated a run of
leading-axis rows at a time (at most 2**27 elements, or one row), which
bounds the float32 transients as the reference's per-row ``lax.map``
does; every value is elementwise, or per last-axis row, so the grouping
changes none of them.

DTensor leaves (a sharded model, :mod:`repro_torch.models.sharding`) get
DTensor moments in the parameter's layout (:func:`opt_state_specs`; a
row scale replicates the last dim), and the update runs on each leaf's
local shard.  Two values need the other shards: the global norm (each
leaf's sum of squares is summed over the mesh dims that shard it, so a
replicated leaf counts once) and an int8 row's absmax where the last dim
is sharded (a max over those dims).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.train.tree import leaves_with_paths, subtree, tree_map

#: leaves above this many elements are reduced and updated in chunks
CHUNK_ELEMS = 1 << 27


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    eightbit: bool = False
    warmup_steps: int = 100
    total_steps: int = 10000


def _f32(x) -> np.float32:
    return np.float32(x)


def lr_at(cfg: OptConfig, step) -> float:
    """Warmup then cosine to 10% of ``cfg.lr``, in float32."""
    s = _f32(int(step))
    warm = np.minimum((s + _f32(1.0)) / _f32(max(cfg.warmup_steps, 1)),
                      _f32(1.0))
    t = np.clip((s - _f32(cfg.warmup_steps))
                / _f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                _f32(0.0), _f32(1.0))
    cos = _f32(0.5) * (_f32(1.0) + np.cos(_f32(np.pi) * t))
    return float(_f32(cfg.lr) * warm * (_f32(0.1) + _f32(0.9) * cos))


# ---------------------------------------------------------------------------
# int8 moment codecs
# ---------------------------------------------------------------------------
def _q8(x, row_groups=()):
    """Symmetric per-row int8 quantization.  x: float32 (..., D); a row
    split over ``row_groups`` takes its absmax over all of them."""
    amax = x.abs().amax(-1, keepdim=True)
    for g in row_groups:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=g)
    # a tensor divisor: on the card a Python-number divisor becomes a
    # multiply by its reciprocal, an ulp off the reference's division
    scale = torch.where(amax > 0, amax / amax.new_tensor(127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dq8(q, scale):
    return q.float() * scale


def _is_dt(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _row_placements(pl, ndim: int):
    """A row scale's placements: the parameter's, with the last dim
    replicated (the reference's scale spec)."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Replicate() if isinstance(p, Shard) and p.dim == ndim - 1
                 else p for p in pl)


def _eightbit(p, cfg: OptConfig) -> bool:
    return cfg.eightbit and p.dim() >= 1 and p.numel() > 4096


def init_opt_state(params, cfg: OptConfig):
    """Zero moments shaped like ``params`` (a Model or a tree of tensors),
    on each parameter's device; DTensor moments for DTensor parameters,
    in their layouts (each rank makes only its shard)."""
    def per_leaf(p):
        if _is_dt(p):
            from torch.distributed.tensor import ones, zeros

            def mk(fill, shape, dtype, row=False):
                pl = (_row_placements(p.placements, p.dim()) if row
                      else p.placements)
                return fill(shape, dtype=dtype, device_mesh=p.device_mesh,
                            placements=pl)
        else:
            ones, zeros = torch.ones, torch.zeros

            def mk(fill, shape, dtype, row=False):
                return fill(shape, dtype=dtype, device=p.device)
        if _eightbit(p, cfg):
            row = tuple(p.shape[:-1]) + (1,)
            return {"m_q": mk(zeros, p.shape, torch.int8),
                    "m_s": mk(ones, row, torch.float32, row=True),
                    "v_q": mk(zeros, p.shape, torch.int8),
                    "v_s": mk(ones, row, torch.float32, row=True)}
        return {"m": mk(zeros, p.shape, torch.float32),
                "v": mk(zeros, p.shape, torch.float32)}

    return tree_map(per_leaf, params)


def opt_state_specs(param_specs_tree, params_shape_tree, cfg: OptConfig):
    """Mirror the parameters' specs onto the optimizer state (the
    reference's): moments take the parameter's spec, a row scale the
    same with its last dim whole.  ``params_shape_tree`` holds each
    leaf's shape (a tuple, or anything with ``.shape``)."""
    from repro_torch.models.sharding import P, is_spec

    def walk(spec, shape):
        if isinstance(spec, dict):
            return {k: walk(spec[k], shape[k]) for k in sorted(spec)}
        if isinstance(spec, list) or (isinstance(spec, tuple)
                                      and not is_spec(spec)):
            return type(spec)(walk(a, b) for a, b in zip(spec, shape))
        shp = tuple(getattr(shape, "shape", shape))
        if cfg.eightbit and len(shp) >= 1 and _size(shp) > 4096:
            s = tuple(spec) + (None,) * (len(shp) - len(spec))
            scale = P(*(s[:-1] + (None,)))
            return {"m_q": spec, "m_s": scale, "v_q": spec, "v_s": scale}
        return {"m": spec, "v": spec}

    return walk(param_specs_tree, params_shape_tree)


def _size(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def _chunked(x) -> bool:
    return x.numel() > CHUNK_ELEMS and x.dim() >= 2 and x.shape[0] > 1


def _row_runs(x):
    """Slices of the leading axis: runs of rows of at most CHUNK_ELEMS
    elements (one row where a row is larger)."""
    rows = max(1, CHUNK_ELEMS // (x.numel() // x.shape[0]))
    return [slice(i, min(i + rows, x.shape[0]))
            for i in range(0, x.shape[0], rows)]


def _sqsum(x):
    return torch.sum(torch.square(x.float()))


def _sharded_dims(x) -> tuple:
    """The mesh dims along which a DTensor is split (empty for a tensor
    or a replicated DTensor)."""
    if not _is_dt(x):
        return ()
    return tuple(i for i, p in enumerate(x.placements) if p.is_shard())


def _local(x):
    return x.to_local() if _is_dt(x) else x


@torch.no_grad()
def global_norm(tree):
    """sqrt of the float32 sum of squares over every leaf; a large leaf is
    reduced a run of rows at a time, so no float32 copy of it is made.
    A DTensor leaf's local sum is summed over the mesh dims that shard it
    (once per leaf layout), so each element counts once."""
    parts: dict = {}
    meshes: dict = {}
    for _, g in leaves_with_paths(tree):
        key = _sharded_dims(g)
        loc = _local(g)
        if _chunked(loc):
            part = sum(_sqsum(loc[s]) for s in _row_runs(loc))
        else:
            part = _sqsum(loc)
        parts[key] = part if key not in parts else parts[key] + part
        if key:
            meshes[key] = g.device_mesh
    total = None
    for key, part in parts.items():
        for d in key:
            dist.all_reduce(part, group=meshes[key].get_group(d))
        total = part if total is None else total + part
    return torch.sqrt(total)


def _leaf_core(p, g, s, clip, lr: float, bc1: float, bc2: float,
               cfg: OptConfig, row_groups=()):
    """One AdamW step of one (chunk of a) leaf, written into ``p`` and
    ``s``; the same float32 operations, in the same order, as the
    reference's ``leaf_core``."""
    g = g.float() * clip
    if "m_q" in s:
        m = _dq8(s["m_q"], s["m_s"])
        v = _dq8(s["v_q"], s["v_s"]) ** 2       # stored as sqrt(v)
    else:
        m, v = s["m"], s["v"]
    m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    v.mul_(cfg.b2).add_((g * (1 - cfg.b2)).mul_(g))
    upd = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
    pf = p.float()                      # p itself for float32 masters
    pf.sub_(upd.add_(pf * cfg.weight_decay).mul_(lr))
    if pf is not p:
        p.copy_(pf)
    if "m_q" in s:
        for name, x in (("m", m), ("v", v.sqrt_())):
            q, scale = _q8(x, row_groups)
            s[name + "_q"].copy_(q)
            s[name + "_s"].copy_(scale)


@torch.no_grad()
def adamw_update(params, grads, state, step, cfg: OptConfig):
    """One AdamW step, in place.  ``params`` is a Model or a tree of
    tensors, ``grads`` a tree of its shape, ``state`` from
    :func:`init_opt_state`.  DTensor leaves are updated on their local
    shards (a gradient is first laid out as its parameter).  Returns
    (params, state, metrics)."""
    for path, p in leaves_with_paths(params):
        g = subtree(grads, path)
        if _is_dt(p) and tuple(g.placements) != tuple(p.placements):
            raise ValueError(f"gradient of {path} laid out as "
                             f"{g.placements}, its parameter as "
                             f"{p.placements}")
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    t = _f32(int(step)) + _f32(1.0)
    bc1 = float(_f32(1.0) - np.power(_f32(cfg.b1), t))
    bc2 = float(_f32(1.0) - np.power(_f32(cfg.b2), t))
    for path, p in leaves_with_paths(params):
        g, s = subtree(grads, path), subtree(state, path)
        row_groups = ()
        if _is_dt(p):
            row_groups = tuple(
                p.device_mesh.get_group(i)
                for i, pl in enumerate(p.placements)
                if pl.is_shard() and pl.dim == p.dim() - 1)
        p, g = _local(p), _local(g)
        s = {k: _local(v) for k, v in s.items()}
        if _chunked(p):
            for rows in _row_runs(p):
                _leaf_core(p[rows], g[rows], {k: v[rows] for k, v in s.items()},
                           clip, lr, bc1, bc2, cfg, row_groups)
        else:
            _leaf_core(p, g, s, clip, lr, bc1, bc2, cfg, row_groups)
    return params, state, {"grad_norm": gnorm, "lr": lr}
