"""Model assembly: parameter templates, init, and the entry points every
architecture exposes:

    forward_train(cfg, params, batch)             -> (logits, aux_loss)
    loss_fn(cfg, params, batch)                   -> (loss, (ce, aux_loss))
    prefill(cfg, params, batch, max_len)          -> (last_logits, cache, cur_len)
    decode_step(cfg, params, cache, tok, cur_len) -> (logits, cache)

The port's copy of `repro.models.model`.  Layer heterogeneity is a repeating group of LayerSpecs; each slot's parameters
are stacked over ``num_groups`` (leading ``G`` dimension, the reference's
layouts and names), and the stack is walked by a Python loop where the
reference scans.  :class:`Model` holds them: ``params["embed"]``,
``params["blocks"][slot]["wq"][g]`` read as the reference's pytree does.

The decode step updates the cache in place (the reference donates it).
Training walks each stacked leaf as ``torch.unbind`` slices, so the
backward stacks a leaf's gradient once; with ``cfg.remat`` each layer is
recomputed in the backward (``torch.utils.checkpoint``), as the
reference's per-layer ``jax.checkpoint`` with ``nothing_saveable``.

Sharded (``shardings=``, from ``train_loop.act_shardings``): the
parameters, batch and cache are DTensors laid out by :func:`param_specs`,
``batch_specs`` and :func:`cache_specs`, most ops run through DTensor's
sharding propagation, and each of the reference's
``with_sharding_constraint`` points is a ``redistribute``.  Where DTensor
has no usable rule, a per-rank body runs on the shards GSPMD would use:
attention (query heads split over tp_a x tp_b, against the KV heads they
read), the Mamba2 convs and SSD scan (heads split, B and C whole), and
the expert-parallel MoE (:func:`repro_torch.models.moe.moe_ffn_sharded`);
the embedding gather reads the whole table, and the CE contracts a
one-hot as the reference does.  Plain tensors (positions, masks) count
as replicated inside :func:`sharded_context`, which the backward needs
too.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models.layers import (
    dtype_of,
    gated_mlp,
    normal_init,
    pdtype_of,
    rms_norm,
)
from repro_torch.models.sharding import P, run_local


# ===========================================================================
# Parameter templates: single source of truth for shapes / roles / init
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    role: str                  # the reference's sharding role
    scale: float = 0.02
    dtype: Optional[str] = None  # override (e.g. f32 for norms/router)
    init: str = "normal"       # "normal" | "zeros" | "ssm_dt" | "ssm_alog"


def _attn_slot_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    G = cfg.num_groups
    D, H, K = cfg.d_model, cfg.num_heads, cfg.kv_heads
    hd = cfg.resolved_head_dim
    out_scale = 0.02 / math.sqrt(2 * cfg.num_layers)
    d = {
        "norm": ParamDef((G, D), "norm", dtype="float32", init="zeros"),
        "wq": ParamDef((G, D, H, hd), "wq"),
        "wk": ParamDef((G, D, K, hd), "wkv"),
        "wv": ParamDef((G, D, K, hd), "wkv"),
        "wo": ParamDef((G, H, hd, D), "wo", scale=out_scale),
    }
    if cfg.sandwich_norm:
        d["post_norm"] = ParamDef((G, D), "norm", dtype="float32", init="zeros")
    return d


def _mamba_slot_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    G = cfg.num_groups
    D, di, st, h, w = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                       cfg.ssm_heads, cfg.conv_width)
    out_scale = 0.02 / math.sqrt(2 * cfg.num_layers)
    d = {
        "norm": ParamDef((G, D), "norm", dtype="float32", init="zeros"),
        "w_x": ParamDef((G, D, di), "ssm_in"),
        "w_z": ParamDef((G, D, di), "ssm_in"),
        "w_B": ParamDef((G, D, st), "ssm_in_state"),
        "w_C": ParamDef((G, D, st), "ssm_in_state"),
        "w_dt": ParamDef((G, D, h), "ssm_dt"),
        "conv_x": ParamDef((G, w, di), "ssm_conv", scale=0.1),
        "conv_B": ParamDef((G, w, st), "ssm_conv", scale=0.1),
        "conv_C": ParamDef((G, w, st), "ssm_conv", scale=0.1),
        "dt_bias": ParamDef((G, h), "ssm_vec", dtype="float32", init="ssm_dt"),
        "A_log": ParamDef((G, h), "ssm_vec", dtype="float32", init="ssm_alog"),
        "D_skip": ParamDef((G, h), "ssm_vec", dtype="float32", init="zeros"),
        "gate_norm": ParamDef((G, di), "ssm_vec", dtype="float32", init="zeros"),
        "w_out": ParamDef((G, di, D), "ssm_out", scale=out_scale),
    }
    if cfg.sandwich_norm:
        d["post_norm"] = ParamDef((G, D), "norm", dtype="float32", init="zeros")
    return d


def _ffn_slot_defs(cfg: ModelConfig, moe: bool) -> Dict[str, ParamDef]:
    G, D, F_ = cfg.num_groups, cfg.d_model, cfg.d_ff
    out_scale = 0.02 / math.sqrt(2 * cfg.num_layers)
    d: Dict[str, ParamDef] = {
        "norm2": ParamDef((G, D), "norm", dtype="float32", init="zeros"),
    }
    if cfg.sandwich_norm:
        d["post_norm2"] = ParamDef((G, D), "norm", dtype="float32", init="zeros")
    mlp = {
        "wi_g": ParamDef((G, D, F_), "wi"),
        "wi_u": ParamDef((G, D, F_), "wi"),
        "wo_m": ParamDef((G, F_, D), "wo_mlp", scale=out_scale),
    }
    if moe:
        E = cfg.num_experts
        d.update({
            "router": ParamDef((G, D, E), "router", dtype="float32"),
            "e_wi_g": ParamDef((G, E, D, F_), "expert_wi"),
            "e_wi_u": ParamDef((G, E, D, F_), "expert_wi"),
            "e_wo": ParamDef((G, E, F_, D), "expert_wo", scale=out_scale),
        })
        if cfg.dense_residual:
            d.update(mlp)
    elif cfg.mlp_gated:
        d.update(mlp)
    else:
        d.update({"wi_u": mlp["wi_u"], "wo_m": mlp["wo_m"]})
    return d


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """Nested dict of ParamDef mirroring the parameter tree."""
    defs: Dict[str, Any] = {}
    D, Vp = cfg.d_model, cfg.vocab_padded
    defs["embed"] = ParamDef((Vp, D), "embed")   # text side exists for all
    if cfg.frontend != "none":
        defs["frontend_proj"] = ParamDef((cfg.frontend_dim, D), "frontend")
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((D, Vp), "head")
    defs["final_norm"] = ParamDef((D,), "norm", dtype="float32", init="zeros")

    blocks = []
    for spec in cfg.group:
        slot: Dict[str, ParamDef] = {}
        if spec.kind == "attn":
            slot.update(_attn_slot_defs(cfg))
        else:
            slot.update(_mamba_slot_defs(cfg))
        if cfg.d_ff > 0:
            slot.update(_ffn_slot_defs(cfg, spec.moe))
        blocks.append(slot)
    defs["blocks"] = blocks
    return defs


def param_dtype(cfg: ModelConfig, d: ParamDef) -> torch.dtype:
    """The master dtype of one parameter."""
    return torch.float32 if d.dtype == "float32" else pdtype_of(cfg)


def iter_defs(cfg: ModelConfig):
    """(path, ParamDef) for every parameter, ``path`` a tuple of keys as in
    the tree (``("blocks", slot, name)`` inside the stack)."""
    defs = param_defs(cfg)
    for name, d in defs.items():
        if name != "blocks":
            yield (name,), d
    for i, slot in enumerate(defs["blocks"]):
        for name, d in slot.items():
            yield ("blocks", i, name), d


class Model(nn.Module):
    """The parameters of one architecture in the reference's layouts.

    ``tree`` is ``{"embed", ["frontend_proj"], ["head"], "final_norm",
    "blocks": [slot dicts]}`` of tensors, every shape as :func:`param_defs`
    gives it.  Parameters carry a gradient only after
    ``requires_grad_()``; serving leaves them without."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg

        def param(t):
            return nn.Parameter(t, requires_grad=False)

        for name, t in tree.items():
            if name != "blocks":
                setattr(self, name, param(t))
        self.blocks = nn.ModuleList(
            nn.ParameterDict({k: param(v) for k, v in slot.items()})
            for slot in tree["blocks"])
        for path, d in iter_defs(cfg):
            got = tuple(self.tensor(path).shape)
            if got != d.shape:
                raise ValueError(f"{cfg.name} {path}: shape {got} != "
                                 f"{d.shape}")

    def __getitem__(self, name: str):
        return getattr(self, name)

    def tensor(self, path) -> torch.Tensor:
        if path[0] == "blocks":
            return self.blocks[path[1]][path[2]]
        return getattr(self, path[0])

    def tree(self) -> Dict[str, Any]:
        """The parameters as the reference's tree: ``{"embed", ...,
        "blocks": [slot dicts]}`` of this model's tensors (no copies)."""
        out: Dict[str, Any] = {"blocks": [dict(slot.items())
                                          for slot in self.blocks]}
        for path, _ in iter_defs(self.cfg):
            if path[0] != "blocks":
                out[path[0]] = self.tensor(path)
        return out

    def weight_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())

    @torch.no_grad()
    def cast_for_serving(self) -> "Model":
        """Hold every matmul weight in the compute dtype, once, in place
        (one tensor at a time, so the peak is the masters plus one
        tensor).  Norms, router, ``dt_bias``, ``A_log`` and ``D_skip`` stay
        float32.  The forward's per-use casts then change nothing, so the
        numbers equal casting at each use."""
        dt = dtype_of(self.cfg)
        for path, d in iter_defs(self.cfg):
            if d.dtype is None:
                p = self.tensor(path)
                if isinstance(p, DTensor):
                    # a DTensor's .data cannot change dtype: a new leaf
                    new = nn.Parameter(p.detach().to(dt),
                                       requires_grad=p.requires_grad)
                    if path[0] == "blocks":
                        self.blocks[path[1]][path[2]] = new
                    else:
                        setattr(self, path[0], new)
                    del p
                else:
                    p.data = p.data.to(dt)
        return self


# ===========================================================================
# Sharding: specs and placement (the reference's param_specs/cache_specs)
# ===========================================================================
_UNSTACKED_ROLES = ("embed", "head", "frontend", "norm", "scalar")


def param_spec(cfg: ModelConfig, d: ParamDef, policy) -> tuple:
    base = tuple(policy.spec(d.role, cfg))
    # block-stacked params have a leading group dim: prepend None
    if d.role not in _UNSTACKED_ROLES and len(d.shape) > len(base):
        return P(None, *base)
    return base


def param_specs(cfg: ModelConfig, policy) -> Dict[str, Any]:
    """The parameter tree's specs (tuples, see
    :mod:`repro_torch.models.sharding`), shaped as :func:`param_defs`."""
    defs = param_defs(cfg)
    out: Dict[str, Any] = {k: param_spec(cfg, d, policy)
                           for k, d in defs.items() if k != "blocks"}
    out["blocks"] = [{k: param_spec(cfg, d, policy) for k, d in slot.items()}
                     for slot in defs["blocks"]]
    return out


def cache_specs(cfg: ModelConfig, policy) -> tuple:
    """The cache's specs, shaped as :func:`init_cache`'s slots."""
    slots = []
    for spec in cfg.group:
        if spec.kind == "attn":
            s = P(None, *policy.cache_spec())
            slots.append({"k": s, "v": s})
        else:
            hs = P(None, *policy.ssm_cache_spec())
            b = policy.dp if not policy.seq_shard_data else None
            slots.append({"h": hs, "conv_x": P(None, b, None, policy.tp_full),
                          "conv_B": P(None, b, None, None),
                          "conv_C": P(None, b, None, None)})
    return tuple(slots)


def place(t: torch.Tensor, policy, spec, src_data_rank: Optional[int] = 0):
    """``t`` as a DTensor on the policy's mesh with ``spec``'s placements.
    ``src_data_rank=0`` scatters rank 0's tensor (the others pass one of
    the same shape); ``None`` keeps each rank's own slice of its own
    ``t`` and moves nothing, and no more than the shard is kept.  A
    DTensor ``t`` already laid out so on the policy's mesh is returned as
    it is (``launch.dryrun`` places a step's inputs before the step, as
    the reference's ``in_shardings`` do); one laid out otherwise raises,
    as ``distribute_tensor`` does."""
    from torch.distributed.tensor import distribute_tensor

    pl = policy.placements(spec)
    if isinstance(t, DTensor):
        if t.device_mesh != policy.mesh or tuple(t.placements) != pl:
            raise ValueError(
                f"a DTensor laid out {tuple(t.placements)} on "
                f"{t.device_mesh} where the spec {spec} wants {pl} on "
                f"{policy.mesh}")
        return t
    out = distribute_tensor(t, policy.mesh, pl, src_data_rank=src_data_rank)
    loc = out.to_local()
    if loc.untyped_storage().nbytes() > loc.numel() * loc.element_size():
        # a view of the full tensor would keep all of it alive
        out = DTensor.from_local(loc.clone(), policy.mesh, pl,
                                 shape=out.shape, stride=out.stride())
    return out


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                policy=None) -> Model:
    """Random masters from one ``torch.Generator`` on ``device`` (default:
    the card), with the reference's distributions and scales; the numbers
    are not the reference's (carry those with
    :func:`repro_torch.models.convert.params_from_reference`).
    ``.requires_grad_()`` on the result gives them gradients.

    With a ``policy`` (its mesh started), every rank makes each full leaf
    in turn from the same generator and keeps its shard as a DTensor
    (:func:`param_specs`): the same weights as without one, and no rank
    holds more than one full leaf at a time."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def mk(d: ParamDef):
        dt = param_dtype(cfg, d)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=dev)
        if d.init == "ssm_dt":
            # dt_bias ~ softplus^-1(uniform(1e-3, 1e-1)) in log space
            lo, hi = math.log(1e-3), math.log(1e-1)
            u = torch.rand(d.shape, generator=gen, device=dev) * (hi - lo) + lo
            dtv = torch.exp(u)
            return (dtv + torch.log(-torch.expm1(-dtv))).to(dt)
        if d.init == "ssm_alog":
            a = torch.rand(d.shape, generator=gen, device=dev) * 15.0 + 1.0
            return torch.log(a).to(dt)
        return normal_init(d.shape, dt, gen, dev, d.scale)

    tree: Dict[str, Any] = {"blocks": [{} for _ in cfg.group]}
    for path, d in iter_defs(cfg):
        t = mk(d)
        if policy is not None:
            t = place(t, policy, param_spec(cfg, d, policy),
                      src_data_rank=None)
        if path[0] == "blocks":
            tree["blocks"][path[1]][path[2]] = t
        else:
            tree[path[0]] = t
    return Model(cfg, tree)


# ===========================================================================
# Forward pass
# ===========================================================================
def _policy(shardings):
    return shardings.get("_policy") if shardings else None


def sharded_context(shardings):
    """The context a sharded pass runs in: plain tensors (positions,
    masks, scalars) count as replicated DTensors, as GSPMD treats
    constants."""
    if _policy(shardings) is None:
        return contextlib.nullcontext()
    return implicit_replication()


def _wsc(x, shardings, name):
    """The reference's ``with_sharding_constraint``: a DTensor is
    redistributed to the placements of the spec named ``name``, and so is
    its gradient (:class:`_Constrained`); anything else is returned as it
    is."""
    if not isinstance(x, DTensor) or shardings is None:
        return x
    spec = shardings.get(name)
    if spec is None:
        return x
    pl = shardings["_policy"].placements(spec)
    y = x if tuple(x.placements) == pl else x.redistribute(
        x.device_mesh, pl)
    if y.requires_grad and torch.is_grad_enabled():
        y = _Constrained.apply(y, pl)
    return y


class _Constrained(torch.autograd.Function):
    """The identity on a DTensor, whose gradient is redistributed to
    ``pl``: ``with_sharding_constraint`` constrains the cotangent as it
    constrains the value.  Left to DTensor, a gradient keeps whatever
    layout the ops after the constraint gave it (the Mamba2 gate's
    gradient arrived with its channels whole, split over the tokens, and
    the product for ``w_z``'s gradient ran whole on every model rank)."""

    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.pl:
            g = g.redistribute(g.device_mesh, ctx.pl)
        return g, None


def _rows(x, shardings):
    """A normed input (B, T, D) laid out as "acts" but with D whole, as
    GSPMD lays it out before a norm and the column-parallel projections
    after it.  Left to DTensor, the norm's partial sums over a split D
    are reduce-scattered onto the sequence, and every op after reshards
    through strided layouts (whose redistribution DTensor plans by a
    search that took minutes a layer at the production meshes)."""
    spec = shardings.get("acts") if shardings else None
    if spec is None:
        return x
    return _wsc(x, {"rows": P(*spec[:-1], None),
                    "_policy": shardings["_policy"]}, "rows")


def _gathered(w, shardings):
    """An FSDP weight gathered over "data" for its use, as GSPMD gathers
    it for a contraction over its split D.  Left to DTensor, the product
    of tokens split over "data" and such a weight may come out with its
    head dim split over more ranks than there are heads a rank, and the
    view into heads fails."""
    from torch.distributed.tensor import Replicate

    policy = _policy(shardings)
    if policy is None or not policy.fsdp or not isinstance(w, DTensor):
        return w
    pl = tuple(Replicate() if a == "data" else p
               for a, p in zip(policy.mesh_axes, w.placements))
    return w if pl == tuple(w.placements) else w.redistribute(
        w.device_mesh, pl)


def _replicated(t: DTensor) -> tuple:
    """``Replicate()`` on every dim of ``t``'s mesh."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * t.device_mesh.ndim


def _embed_inputs(cfg: ModelConfig, params, batch):
    dt = dtype_of(cfg)
    if cfg.frontend != "none" and "embeds" in batch:
        x = torch.einsum("btf,fd->btd", batch["embeds"].to(dt),
                         params["frontend_proj"].to(dt))
    else:
        table, tokens = params["embed"], batch["tokens"]
        if isinstance(table, DTensor):
            # the gather's backward (index_put into a split table) has no
            # working DTensor rule in every torch: gather from the whole
            # table with every token, as GSPMD may
            rep = _replicated(table)
            table = table.redistribute(table.device_mesh, rep)
            if isinstance(tokens, DTensor):
                tokens = tokens.redistribute(tokens.device_mesh, rep)
        # gather, then cast: the same numbers as casting the whole table
        x = table[tokens].to(dt)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)
    return x


def _positions(cfg: ModelConfig, batch, T: int):
    if "positions" in batch:
        return batch["positions"]
    src = batch["tokens"] if "tokens" in batch else batch["embeds"]
    B = src.shape[0]
    return torch.arange(T, device=src.device).expand(B, T)


def _slot(p, g: int) -> Dict[str, torch.Tensor]:
    """Group ``g``'s layer of one stacked slot: views, no copies."""
    return {k: v[g] for k, v in p.items()}


def _write(dst, start: int, src):
    """``dst[:, start:start + n] = src`` (n = src.shape[1]) for a cache
    view (B, S, ...); a DTensor ``dst`` is written on each rank's own
    shard, whichever rows of S it holds."""
    if not isinstance(dst, DTensor):
        dst[:, start:start + src.shape[1]] = src
        return
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.sharding import shard_extent

    mesh, pl = dst.device_mesh, dst.placements
    if isinstance(src, DTensor):     # dst's layout, with S whole
        src = src.redistribute(mesh, tuple(
            Replicate() if isinstance(p, Shard) and p.dim == 1 else p
            for p in pl)).to_local()
    shape, off = shard_extent(
        dst.shape, [mesh.size(i) for i in range(mesh.ndim)],
        mesh.get_coordinate(), pl)
    lo = max(start, off[1])
    hi = min(start + src.shape[1], off[1] + shape[1])
    if lo < hi:
        dst.to_local()[:, lo - off[1]:hi - off[1]] = \
            src[:, lo - start:hi - start]


def _assign(dst, src):
    """``dst.copy_(src)``, on each rank's own shard for DTensors."""
    if isinstance(dst, DTensor):
        if isinstance(src, DTensor):
            src = src.redistribute(dst.device_mesh, dst.placements).to_local()
        dst.to_local().copy_(src)
    else:
        dst.copy_(src)


def _attn_sharded(cfg, spec, q, k, v, policy, cache_kv, cur_len):
    """Attention on DTensors: q (B, T, H, hd), k/v (B, T, K, hd).  Query
    heads split over ("tp_a", "tp_b") as the reference's "q" constraint
    splits them, KV heads over "tp_a" (its "kv"); batch over dp, or
    nothing where the sequence is sharded (attention needs it whole).
    Each rank attends its own query heads against the KV heads they read,
    so no collective runs inside; the output keeps q's layout.  A decode
    step first writes the new keys into the cache views, on each rank's
    own shard."""
    G = cfg.num_heads // cfg.kv_heads
    b = None if policy.seq_shard_data else policy.dp
    q_pl = policy.placements((b, None, policy.tp_heads, None))
    kv_pl = policy.placements((b, None, "tp_a", None))
    coord_a = policy.coord("tp_a")
    coord = coord_a * policy.tp_b + policy.coord("tp_b")
    if cache_kv is not None:
        for c, new in zip(cache_kv, (k, v)):
            _write(c, cur_len - 1, new)
        k, v = cache_kv

    def body(ql, kl, vl):
        Bl, Tl, Hl, hd = ql.shape
        h0 = coord * Hl                      # first global head held here
        i0 = h0 // G - coord_a * kl.shape[2]  # its KV head, locally
        if Hl % G == 0 and h0 % G == 0:      # whole groups
            kp, gp = Hl // G, G
            ks, vs = kl[:, :, i0:i0 + kp], vl[:, :, i0:i0 + kp]
        elif G % Hl == 0:                    # part of one group
            kp, gp = 1, Hl
            ks, vs = kl[:, :, i0:i0 + 1], vl[:, :, i0:i0 + 1]
        else:                                # any heads: one KV each
            kp, gp = Hl, 1
            idx = (h0 + torch.arange(Hl, device=ql.device)) // G \
                - coord_a * kl.shape[2]
            ks, vs = kl[:, :, idx], vl[:, :, idx]
        q5 = ql.reshape(Bl, Tl, kp, gp, hd)
        if cache_kv is None:
            o = A.blockwise_attention(q5, ks, vs, causal=cfg.causal,
                                      window=spec.window,
                                      softcap=cfg.attn_softcap)
        else:
            o = A.decode_attention(q5, ks, vs, cur_len, window=spec.window,
                                   softcap=cfg.attn_softcap)
        return (o.reshape(Bl, Tl, Hl, hd),)

    # the "tp_b" ranks read the same KV heads for different query heads
    (o,) = run_local(body, policy, [(q, q_pl), (k, kv_pl), (v, kv_pl)],
                      [q_pl], split=("tp_b",))
    return o, (k, v)


def _attn_apply(cfg: ModelConfig, spec: LayerSpec, p, x, cos, sin,
                cache_kv=None, cur_len=None, shardings=None):
    """Returns (attn_out, (k, v)): the new keys and values for a prompt,
    the updated cache views for a decode step (written in place)."""
    dt = dtype_of(cfg)
    B, T, D = x.shape
    H, K = cfg.num_heads, cfg.kv_heads
    hd = cfg.resolved_head_dim
    G = H // K
    wq, wk, wv = (_gathered(p[n], shardings) for n in ("wq", "wk", "wv"))
    q = torch.einsum("btd,dnh->btnh", x, wq.to(dt))
    k = torch.einsum("btd,dkh->btkh", x, wk.to(dt))
    v = torch.einsum("btd,dkh->btkh", x, wv.to(dt))
    if cfg.rope_kind != "none":
        q = A.apply_rope(q, cos, sin)
        k = A.apply_rope(k, cos, sin)
    policy = _policy(shardings)
    if policy is not None and isinstance(q, DTensor):
        o, new_kv = _attn_sharded(cfg, spec, q, k, v, policy, cache_kv,
                                  cur_len)
    else:
        q = q.reshape(B, T, K, G, hd)
        if cache_kv is None:
            o = A.blockwise_attention(q, k, v, causal=cfg.causal,
                                      window=spec.window,
                                      softcap=cfg.attn_softcap)
            new_kv = (k, v)
        else:
            k_cache, v_cache = cache_kv
            if T == 1:
                k_cache[:, cur_len - 1] = k[:, 0]
                v_cache[:, cur_len - 1] = v[:, 0]
            o = A.decode_attention(q, k_cache, v_cache, cur_len,
                                   window=spec.window,
                                   softcap=cfg.attn_softcap)
            new_kv = (k_cache, v_cache)
    # the output projection over (heads, head dim) flattened head-major,
    # sharded or not (one order of the sums): an einsum may merge the two
    # in the other order, which DTensor cannot lay out for split heads
    out = torch.matmul(o.reshape(B, T, H * hd),
                       p["wo"].to(dt).reshape(H * hd, D))
    return out, new_kv


def _ssm_core(cfg: ModelConfig, xz, Bm, Cm, dtv, Aneg, D_skip, conv_x,
              conv_B, conv_C, cache=None):
    """The Mamba2 mixer between the projections and the gate: causal
    convs, SSD scan (or one recurrent step against ``cache``, written in
    place) and the D skip.  Heads are independent, so any whole-head
    slice of (xz, dtv, Aneg, D_skip, conv_x) with B and C whole gives
    that slice of the output.  Returns (y (B, T, h*hd), state)."""
    dt_ = dtype_of(cfg)
    B, T, _ = xz.shape
    hd = cfg.ssm_head_dim
    h = xz.shape[-1] // hd
    w = cfg.conv_width
    if cache is None:
        # the conv tail comes from the *pre-activation* conv inputs
        new_cache = {"conv_x": xz[:, T - (w - 1):],
                     "conv_B": Bm[:, T - (w - 1):],
                     "conv_C": Cm[:, T - (w - 1):]}
        xc = F.silu(M2.causal_conv(xz, conv_x.to(dt_)))
        Bc = F.silu(M2.causal_conv(Bm, conv_B.to(dt_)))
        Cc = F.silu(M2.causal_conv(Cm, conv_C.to(dt_)))
        xh = xc.reshape(B, T, h, hd)
        y, new_cache["h"] = M2.ssd_chunked(xh, dtv, Aneg, Bc, Cc,
                                           cfg.ssm_chunk)
    else:
        xt, cs_x = M2.conv_decode(xz[:, 0], cache["conv_x"], conv_x.to(dt_))
        Bt, cs_B = M2.conv_decode(Bm[:, 0], cache["conv_B"], conv_B.to(dt_))
        Ct, cs_C = M2.conv_decode(Cm[:, 0], cache["conv_C"], conv_C.to(dt_))
        xt, Bt, Ct = F.silu(xt), F.silu(Bt), F.silu(Ct)
        xh = xt.reshape(B, 1, h, hd)
        y1, h_next = M2.ssd_decode(xh[:, 0], dtv[:, 0], Aneg, Bt, Ct,
                                   cache["h"].float())
        y = y1[:, None]
        for name, new in (("h", h_next), ("conv_x", cs_x), ("conv_B", cs_B),
                          ("conv_C", cs_C)):
            cache[name].copy_(new)
        new_cache = cache
    # D skip-connection (per head, broadcast over head_dim)
    y = y + D_skip.float()[None, None, :, None].to(y.dtype) * xh
    return y.reshape(B, T, h * hd), new_cache


_SSM_STATE = ("h", "conv_x", "conv_B", "conv_C")


def _ssm_sharded(cfg: ModelConfig, policy, args, cache):
    """:func:`_ssm_core` on DTensors: heads over the model axes where they
    divide into whole heads per rank (else every rank runs all of them),
    B and C whole, batch over dp (the sequence whole: the scan needs
    it).  The state comes back in the cache's layout."""
    tp = policy.tp_full if cfg.ssm_heads % policy.model_size == 0 else None
    b = None if policy.seq_shard_data else policy.dp
    chan = policy.placements((b, None, tp))        # (B, T, channels)
    rep = policy.placements((b, None, None))
    vec = policy.placements((tp,))
    conv = policy.placements((None, tp))
    whole = policy.placements((None, None))
    st_pl = {"h": policy.placements((b, tp, None, None)), "conv_x": chan,
             "conv_B": rep, "conv_C": rep}
    xz, Bm, Cm, dtv, Aneg, D_skip, conv_x, conv_B, conv_C = args
    ins = [(xz, chan), (Bm, rep), (Cm, rep), (dtv, chan), (Aneg, vec),
           (D_skip, vec), (conv_x, conv), (conv_B, whole), (conv_C, whole)]
    if cache is not None:
        # the step runs on copies in the core's layout, written back after
        ins += [(cache[n], st_pl[n]) for n in _SSM_STATE]

    def body(*locs):
        st = None if cache is None else dict(zip(_SSM_STATE, locs[9:]))
        y, new = _ssm_core(cfg, *locs[:9], cache=st)
        return (y,) + tuple(new[n] for n in _SSM_STATE)

    # heads (where tp) and batch rows (where b) split across ranks
    split = (tp or ()) + (b or ())
    y, *state = run_local(body, policy, ins,
                           [chan] + [st_pl[n] for n in _SSM_STATE], split)
    new = dict(zip(_SSM_STATE, state))
    if cache is not None:
        for n in _SSM_STATE:
            _assign(cache[n], new[n])
        new = cache
    return y, new


def _mamba_apply(cfg: ModelConfig, p, x, cache=None, shardings=None):
    """Mamba2 block.  Returns (out, state): the prompt's final state, or
    the cache views updated in place for a decode step."""
    dt_ = dtype_of(cfg)
    xz = _wsc(torch.einsum("btd,de->bte", x, p["w_x"].to(dt_)), shardings,
              "ssm_inner")
    z = _wsc(torch.einsum("btd,de->bte", x, p["w_z"].to(dt_)), shardings,
             "ssm_inner")
    Bm = torch.einsum("btd,ds->bts", x, p["w_B"].to(dt_))
    Cm = torch.einsum("btd,ds->bts", x, p["w_C"].to(dt_))
    dt_raw = torch.einsum("btd,dh->bth", x, p["w_dt"].to(dt_))
    dtv = F.softplus(dt_raw.float() + p["dt_bias"].float())
    Aneg = -torch.exp(p["A_log"].float())
    args = (xz, Bm, Cm, dtv, Aneg, p["D_skip"], p["conv_x"], p["conv_B"],
            p["conv_C"])
    policy = _policy(shardings)
    if policy is not None and isinstance(xz, DTensor):
        y, new_cache = _ssm_sharded(cfg, policy, args, cache)
    else:
        y, new_cache = _ssm_core(cfg, *args, cache=cache)
    gated = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = torch.einsum("bte,ed->btd", gated.to(dt_), p["w_out"].to(dt_))
    return out, new_cache


def _ffn_apply(cfg: ModelConfig, spec: LayerSpec, p, x, shardings=None):
    """Dense or MoE FFN.  Returns (out, aux_loss).  Under a policy the MoE
    runs expert-parallel (:func:`repro_torch.models.moe.moe_ffn_sharded`),
    as the reference's does."""
    dt = dtype_of(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.moe:
        policy = _policy(shardings)
        moe = (MOE.moe_ffn if policy is None else
               lambda *a: MOE.moe_ffn_sharded(*a, policy))
        y, aux = moe(cfg, x, p["router"], p["e_wi_g"].to(dt),
                     p["e_wi_u"].to(dt), p["e_wo"].to(dt))
        if cfg.dense_residual:
            y = y + gated_mlp(x, p["wi_g"].to(dt), p["wi_u"].to(dt),
                              p["wo_m"].to(dt))
    elif cfg.mlp_gated:
        y = gated_mlp(x, p["wi_g"].to(dt), p["wi_u"].to(dt),
                      p["wo_m"].to(dt))
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(torch.einsum("...d,df->...f", x, p["wi_u"].to(dt)),
                   approximate="tanh")
        y = torch.einsum("...f,fd->...d", h, p["wo_m"].to(dt))
    return y, aux


def _block_apply(cfg: ModelConfig, spec: LayerSpec, p, x, cos, sin,
                 cache=None, cur_len=None, shardings=None):
    """One layer: (attn|mamba) + optional FFN, pre-norm residual.
    Returns (x, new_cache, aux)."""
    h_in = rms_norm(_rows(x, shardings), p["norm"], cfg.norm_eps)
    if spec.kind == "attn":
        mix, new_cache = _attn_apply(
            cfg, spec, p, h_in, cos, sin,
            cache_kv=None if cache is None else (cache["k"], cache["v"]),
            cur_len=cur_len, shardings=shardings)
        if cache is not None:
            new_cache = {"k": new_cache[0], "v": new_cache[1]}
    else:
        mix, new_cache = _mamba_apply(cfg, p, h_in, cache=cache,
                                      shardings=shardings)
    if cfg.sandwich_norm:
        mix = rms_norm(mix, p["post_norm"], cfg.norm_eps)
    x = x + mix

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.d_ff > 0:
        h2 = rms_norm(_rows(x, shardings), p["norm2"], cfg.norm_eps)
        y, aux = _ffn_apply(cfg, spec, p, h2, shardings=shardings)
        if cfg.sandwich_norm:
            y = rms_norm(y, p["post_norm2"], cfg.norm_eps)
        x = x + y
    return x, new_cache, aux


def _logits(cfg: ModelConfig, params, x, shardings=None):
    dt = dtype_of(cfg)
    x = rms_norm(_rows(x, shardings), params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("btd,vd->btv", x, params["embed"].to(dt))
    else:
        logits = torch.einsum("btd,dv->btv", x, params["head"].to(dt))
    logits = logits.float()
    if cfg.final_softcap:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return _wsc(logits, shardings, "logits")


def _rope(cfg: ModelConfig, pos):
    return (A.rope_angles(cfg, pos) if cfg.rope_kind != "none"
            else (None, None))


def forward_hidden(cfg: ModelConfig, params, batch, shardings=None):
    """Run the layer stack.  Returns (hidden (B,T,D), aux_loss).

    Each stacked leaf is split once (``torch.unbind``): the backward of G
    slices is one stack, where indexing each group would write a zero
    tensor the size of the whole stack per group.  With ``cfg.remat`` and
    gradients on, each layer is checkpointed and recomputed in the
    backward.  ``shardings`` (``train_loop.act_shardings``) makes it a
    sharded pass over DTensor parameters and batch: the layer-boundary
    activations are redistributed to its "acts" spec."""
    with sharded_context(shardings):
        x = _embed_inputs(cfg, params, batch)
        T = x.shape[1]
        cos, sin = _rope(cfg, _positions(cfg, batch, T))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        x = _wsc(x, shardings, "acts")
        layers = [{k: torch.unbind(v, 0) for k, v in p.items()}
                  for p in params["blocks"]]

    def layer_fn(spec, p, x):
        with sharded_context(shardings):     # also when recomputed in backward
            x, _, a = _block_apply(cfg, spec, p, x, cos, sin,
                                   shardings=shardings)
            return _wsc(x, shardings, "acts"), a

    remat = cfg.remat and torch.is_grad_enabled()
    for g in range(cfg.num_groups):
        for spec, stack in zip(cfg.group, layers):
            p = {k: v[g] for k, v in stack.items()}
            if remat:
                x, a = checkpoint(layer_fn, spec, p, x, use_reentrant=False)
            else:
                x, a = layer_fn(spec, p, x)
            with sharded_context(shardings):
                aux = aux + a
    with sharded_context(shardings):
        return x, aux / cfg.num_layers


def forward_train(cfg: ModelConfig, params, batch, shardings=None):
    """Full-sequence forward.  Returns (logits (B,T,Vp) f32, aux_loss)."""
    x, aux = forward_hidden(cfg, params, batch, shardings)
    with sharded_context(shardings):
        return _logits(cfg, params, x, shardings), aux


def _ce_terms(cfg: ModelConfig, params, x, labels, shardings=None):
    """(nll_sum, valid_count) of one chunk; its logits never escape.  The
    label's logit is gathered; a sharded pass contracts a one-hot as the
    reference does (the same number, and the vocab stays sharded)."""
    with sharded_context(shardings):
        logits = _logits(cfg, params, x, shardings)
        valid = (labels >= 0) & (labels < cfg.vocab)
        labels_c = torch.clamp(labels, 0, cfg.vocab_padded - 1).long()
        logz = torch.logsumexp(logits, dim=-1)
        if isinstance(logits, DTensor):
            viota = torch.arange(logits.shape[-1], device=logits.device)
            ll = torch.where(viota == labels_c[..., None], logits,
                             0.0).sum(-1)
        else:
            ll = torch.gather(logits, -1, labels_c[..., None])[..., 0]
        nll = (logz - ll) * valid
        return nll.sum(), valid.sum()


def loss_fn(cfg: ModelConfig, params, batch, *, aux_weight: float = 0.01,
            ce_chunks: int = 8, shardings=None):
    """CE loss with the head and softmax chunked over T: one (B, T/chunks,
    V) logits block at a time, checkpointed (recomputed in the backward)
    when gradients are on, so the full (B, T, V) tensor never exists.
    Returns (loss + aux_weight * aux, (ce, aux))."""
    x, aux = forward_hidden(cfg, params, batch, shardings)
    labels = batch["labels"]
    T = x.shape[1]
    while T % ce_chunks:
        ce_chunks //= 2
    if ce_chunks <= 1:
        ns, nv = _ce_terms(cfg, params, x, labels, shardings)
    else:
        C = T // ce_chunks
        ns, nv = 0.0, 0
        for i in range(ce_chunks):
            with sharded_context(shardings):
                xi = x[:, i * C:(i + 1) * C]
                li = labels[:, i * C:(i + 1) * C]
            if torch.is_grad_enabled():
                s, v = checkpoint(_ce_terms, cfg, params, xi, li, shardings,
                                  use_reentrant=False)
            else:
                s, v = _ce_terms(cfg, params, xi, li, shardings)
            with sharded_context(shardings):
                ns, nv = ns + s, nv + v
    with sharded_context(shardings):
        loss = ns / torch.clamp(nv, min=1)
        return loss + aux_weight * aux, (loss, aux)


# ===========================================================================
# Serving: cache init / prefill / decode
# ===========================================================================
def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               policy=None):
    """Cache: per slot a dict of zero tensors stacked over groups (leading
    G dim), in the reference's layouts and dtypes; with a ``policy``,
    DTensors laid out by :func:`cache_specs` (each rank makes only its
    shard)."""
    dev = resolve_device(device)
    dt = dtype_of(cfg)
    G = cfg.num_groups
    K, hd = cfg.kv_heads, cfg.resolved_head_dim
    specs = None if policy is None else iter(
        s for slot in cache_specs(cfg, policy) for s in slot.values())

    def z(shape, dtype):
        if specs is None:
            return torch.zeros(shape, dtype=dtype, device=dev)
        from torch.distributed.tensor import zeros

        return zeros(shape, dtype=dtype, device_mesh=policy.mesh,
                     placements=policy.placements(next(specs)))

    slots = []
    for spec in cfg.group:
        if spec.kind == "attn":
            slots.append({"k": z((G, batch, max_len, K, hd), dt),
                          "v": z((G, batch, max_len, K, hd), dt)})
        else:
            w1 = cfg.conv_width - 1
            slots.append({
                "h": z((G, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                        cfg.ssm_state), torch.float32),
                "conv_x": z((G, batch, w1, cfg.d_inner), dt),
                "conv_B": z((G, batch, w1, cfg.ssm_state), dt),
                "conv_C": z((G, batch, w1, cfg.ssm_state), dt),
            })
    return tuple(slots)


def cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for slot in cache
               for t in slot.values())


def prefill(cfg: ModelConfig, params, batch, max_len: int, shardings=None):
    """Forward over a prompt, building the cache.  Returns (last_logits
    (B,1,Vp), cache, cur_len = T).  Under ``shardings`` the cache is made
    of DTensors laid out by :func:`cache_specs`."""
    with sharded_context(shardings):
        x = _embed_inputs(cfg, params, batch)
        B, T, _ = x.shape
        cos, sin = _rope(cfg, _positions(cfg, batch, T))
        x = _wsc(x, shardings, "acts")
        cache = init_cache(cfg, B, max_len, device=x.device,
                           policy=_policy(shardings))
        for g in range(cfg.num_groups):
            for spec, p, c in zip(cfg.group, params["blocks"], cache):
                x, nc, _ = _block_apply(cfg, spec, _slot(p, g), x, cos, sin,
                                        shardings=shardings)
                if spec.kind == "attn":
                    _write(c["k"][g], 0, nc[0])
                    _write(c["v"][g], 0, nc[1])
                else:
                    for name, t in nc.items():
                        _assign(c[name][g], t)
            x = _wsc(x, shardings, "acts")
        logits = _logits(cfg, params, x[:, -1:], shardings)
    return logits, cache, T


def decode_step(cfg: ModelConfig, params, cache, tokens, cur_len: int,
                shardings=None):
    """One decode step.  tokens: (B, 1) int; cur_len: length *including*
    the new token.  Returns (logits (B,1,Vp), cache), the cache updated in
    place."""
    with sharded_context(shardings):
        x = _embed_inputs(cfg, params, {"tokens": tokens})
        B = x.shape[0]
        pos = torch.full((B, 1), cur_len - 1, dtype=torch.int64,
                         device=x.device)
        if cfg.rope_kind == "mrope":
            pos = pos[..., None].expand(B, 1, 3)
        cos, sin = _rope(cfg, pos)
        for g in range(cfg.num_groups):
            for spec, p, c in zip(cfg.group, params["blocks"], cache):
                x, _, _ = _block_apply(cfg, spec, _slot(p, g), x, cos, sin,
                                       cache=_slot(c, g), cur_len=cur_len,
                                       shardings=shardings)
        return _logits(cfg, params, x, shardings), cache
