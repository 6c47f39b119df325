"""The (architecture × input-shape) cell matrix.

The port's copy of `repro.launch.cells`.  Shapes (assigned):
    train_4k     seq 4096,   global_batch 256  -> train_step
    prefill_32k  seq 32768,  global_batch 32   -> prefill (forward for
                                                  encoder-only archs)
    decode_32k   seq 32768,  global_batch 128  -> decode_step (1 new token,
                                                  cache of seq_len)
    long_500k    seq 524288, global_batch 1    -> decode_step; only for
                                                  sub-quadratic archs

:func:`input_specs` returns a :class:`ShapeDtypeStruct` stand-in for every
input, in the reference's trees and leaf names, at zero allocation (the
dry run places fake tensors of these shapes).  The parameters' leaves come
from ``param_defs``; the optimizer state and the cache from the port's own
``init_opt_state`` and ``init_cache`` on the ``meta`` device, so they
follow what the port's steps take (the int8 codec for ``opt_8bit`` archs).
Skips: long_500k only for mamba2/jamba; hubert (encoder-only) has no
decode shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig, get_config, list_archs
from repro_torch.models import model as M
from repro_torch.train.tree import tree_map


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}

SUBQUADRATIC = {"mamba2-2.7b", "jamba-1.5-large"}


def cell_applicable(arch: str, shape_name: str):
    """Returns (applicable, reason_if_not)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "decode" and not cfg.causal:
        return False, "encoder-only arch has no autoregressive decode step"
    if shape_name == "long_500k" and arch not in SUBQUADRATIC:
        return False, ("full-attention arch: 500k context needs sub-quadratic "
                       "attention (see docs/DESIGN.md §5)")
    return True, ""


def all_cells():
    """Every (arch, shape) incl. skips: [(arch, shape, applicable, reason)]."""
    out = []
    for arch in list_archs():
        for sname in SHAPES:
            ok, why = cell_applicable(arch, sname)
            out.append((arch, sname, ok, why))
    return out


# ---------------------------------------------------------------------------
# (shape, dtype) input stand-ins
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeDtypeStruct:
    """The port's ``jax.ShapeDtypeStruct``: a leaf's shape and dtype."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        n = self.dtype.itemsize
        for s in self.shape:
            n *= s
        return n


def _sds(shape, dtype) -> ShapeDtypeStruct:
    return ShapeDtypeStruct(tuple(shape), dtype)


def _of(t) -> ShapeDtypeStruct:
    return _sds(t.shape, t.dtype)


def batch_input_specs(cfg: ModelConfig, B: int, T: int, *, train: bool):
    d = {}
    if cfg.frontend == "none":
        d["tokens"] = _sds((B, T), torch.int32)
    else:
        d["embeds"] = _sds((B, T, cfg.frontend_dim), torch.bfloat16)
        if cfg.rope_kind == "mrope":
            d["positions"] = _sds((B, T, 3), torch.int32)
    if train:
        d["labels"] = _sds((B, T), torch.int32)
    return d


def params_specs_abstract(cfg: ModelConfig):
    """The parameter tree (``Model.tree()``'s shape) of stand-ins."""
    tree = {"blocks": [{} for _ in cfg.group]}
    for path, d in M.iter_defs(cfg):
        sds = _sds(d.shape, M.param_dtype(cfg, d))
        if path[0] == "blocks":
            tree["blocks"][path[1]][path[2]] = sds
        else:
            tree[path[0]] = sds
    return tree


def _on_meta(tree):
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), tree)


def opt_specs_abstract(params, opt):
    """The optimizer state of ``params`` (stand-ins), as the port's
    ``init_opt_state`` makes it."""
    from repro_torch.train.optimizer import init_opt_state

    return tree_map(_of, init_opt_state(_on_meta(params), opt))


def cache_specs_abstract(cfg: ModelConfig, B: int, max_len: int):
    return tree_map(_of, M.init_cache(cfg, B, max_len, device="meta"))


def input_specs(arch: str, shape_name: str, *, opt=None, smoke: bool = False,
                cfg: ModelConfig = None, shape: Shape = None):
    """All inputs for the cell's step function, as ShapeDtypeStructs.

    train  -> (params, opt_state, batch, step_idx)
    prefill-> (params, batch)
    decode -> (params, cache, tokens, cur_len)

    ``cfg``/``shape`` replace ``get_config(arch, smoke)``/``SHAPES[
    shape_name]`` (a config cut in depth, a shape of one's own)."""
    cfg = cfg or get_config(arch, smoke=smoke)
    shape = shape or SHAPES[shape_name]
    B, T = shape.global_batch, shape.seq_len
    params = params_specs_abstract(cfg)
    if shape.kind == "train":
        from repro_torch.train.optimizer import OptConfig

        opt = opt or OptConfig(eightbit=cfg.opt_8bit)
        batch = batch_input_specs(cfg, B, T, train=True)
        return (params, opt_specs_abstract(params, opt), batch,
                _sds((), torch.int32))
    if shape.kind == "prefill":
        batch = batch_input_specs(cfg, B, T, train=False)
        return (params, batch)
    # decode
    cache = cache_specs_abstract(cfg, B, T)
    tokens = _sds((B, 1), torch.int32)
    return (params, cache, tokens, _sds((), torch.int32))
