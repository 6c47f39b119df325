"""AdamW with optional 8-bit (int8, per-row absmax) first/second moments.

The port's copy of `repro.train.optimizer` without ``opt_state_specs``
(sharding specs are the multi-card slice's).  8-bit moments cut optimizer
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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
def _q8(x):
    """Symmetric per-row int8 quantization.  x: float32 (..., D)."""
    amax = x.abs().amax(-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dq8(q, scale):
    return q.float() * scale


def init_opt_state(params, cfg: OptConfig):
    """Zero moments shaped like ``params`` (a Model or a tree of tensors),
    on each parameter's device."""
    def per_leaf(p):
        kw = dict(device=p.device)
        if cfg.eightbit and p.dim() >= 1 and p.numel() > 4096:
            row = tuple(p.shape[:-1]) + (1,)
            return {"m_q": torch.zeros(p.shape, dtype=torch.int8, **kw),
                    "m_s": torch.ones(row, dtype=torch.float32, **kw),
                    "v_q": torch.zeros(p.shape, dtype=torch.int8, **kw),
                    "v_s": torch.ones(row, dtype=torch.float32, **kw)}
        return {"m": torch.zeros(p.shape, dtype=torch.float32, **kw),
                "v": torch.zeros(p.shape, dtype=torch.float32, **kw)}

    return tree_map(per_leaf, params)


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


@torch.no_grad()
def global_norm(tree):
    """sqrt of the float32 sum of squares over every leaf; a large leaf is
    reduced a run of rows at a time, so no float32 copy of it is made."""
    total = None
    for _, g in leaves_with_paths(tree):
        if _chunked(g):
            part = sum(_sqsum(g[s]) for s in _row_runs(g))
        else:
            part = _sqsum(g)
        total = part if total is None else total + part
    return torch.sqrt(total)


def _leaf_core(p, g, s, clip, lr: float, bc1: float, bc2: float,
               cfg: OptConfig):
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
            q, scale = _q8(x)
            s[name + "_q"].copy_(q)
            s[name + "_s"].copy_(scale)


@torch.no_grad()
def adamw_update(params, grads, state, step, cfg: OptConfig):
    """One AdamW step, in place.  ``params`` is a Model or a tree of
    tensors, ``grads`` a tree of its shape, ``state`` from
    :func:`init_opt_state`.  Returns (params, state, metrics)."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    t = _f32(int(step)) + _f32(1.0)
    bc1 = float(_f32(1.0) - np.power(_f32(cfg.b1), t))
    bc2 = float(_f32(1.0) - np.power(_f32(cfg.b2), t))
    for path, p in leaves_with_paths(params):
        g, s = subtree(grads, path), subtree(state, path)
        if _chunked(p):
            for rows in _row_runs(p):
                _leaf_core(p[rows], g[rows], {k: v[rows] for k, v in s.items()},
                           clip, lr, bc1, bc2, cfg)
        else:
            _leaf_core(p, g, s, clip, lr, bc1, bc2, cfg)
    return params, state, {"grad_norm": gnorm, "lr": lr}
