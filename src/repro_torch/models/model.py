"""Model assembly: parameter templates, init, and the entry points every
architecture exposes:

    forward_train(cfg, params, batch)             -> (logits, aux_loss)
    loss_fn(cfg, params, batch)                   -> (loss, (ce, aux_loss))
    prefill(cfg, params, batch, max_len)          -> (last_logits, cache, cur_len)
    decode_step(cfg, params, cache, tok, cur_len) -> (logits, cache)

The port's copy of `repro.models.model` without its sharding.  Layer
heterogeneity is a repeating group of LayerSpecs; each slot's parameters
are stacked over ``num_groups`` (leading ``G`` dimension, the reference's
layouts and names), and the stack is walked by a Python loop where the
reference scans.  :class:`Model` holds them: ``params["embed"]``,
``params["blocks"][slot]["wq"][g]`` read as the reference's pytree does.

The decode step updates the cache in place (the reference donates it).
Training walks each stacked leaf as ``torch.unbind`` slices, so the
backward stacks a leaf's gradient once; with ``cfg.remat`` each layer is
recomputed in the backward (``torch.utils.checkpoint``), as the
reference's per-layer ``jax.checkpoint`` with ``nothing_saveable``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
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
                p.data = p.data.to(dt)
        return self


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Model:
    """Random masters from one ``torch.Generator`` on ``device`` (default:
    the card), with the reference's distributions and scales; the numbers
    are not the reference's (carry those with
    :func:`repro_torch.models.convert.params_from_reference`).
    ``.requires_grad_()`` on the result gives them gradients."""
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
        if path[0] == "blocks":
            tree["blocks"][path[1]][path[2]] = mk(d)
        else:
            tree[path[0]] = mk(d)
    return Model(cfg, tree)


# ===========================================================================
# Forward pass
# ===========================================================================
def _embed_inputs(cfg: ModelConfig, params, batch):
    dt = dtype_of(cfg)
    if cfg.frontend != "none" and "embeds" in batch:
        x = torch.einsum("btf,fd->btd", batch["embeds"].to(dt),
                         params["frontend_proj"].to(dt))
    else:
        # gather, then cast: the same numbers as casting the whole table
        x = params["embed"][batch["tokens"]].to(dt)
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


def _attn_apply(cfg: ModelConfig, spec: LayerSpec, p, x, cos, sin,
                cache_kv=None, cur_len=None):
    """Returns (attn_out, (k, v)): the new keys and values for a prompt,
    the updated cache views for a decode step (written in place)."""
    dt = dtype_of(cfg)
    B, T, D = x.shape
    H, K = cfg.num_heads, cfg.kv_heads
    hd = cfg.resolved_head_dim
    G = H // K
    q = torch.einsum("btd,dnh->btnh", x, p["wq"].to(dt))
    k = torch.einsum("btd,dkh->btkh", x, p["wk"].to(dt))
    v = torch.einsum("btd,dkh->btkh", x, p["wv"].to(dt))
    if cfg.rope_kind != "none":
        q = A.apply_rope(q, cos, sin)
        k = A.apply_rope(k, cos, sin)
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
                               window=spec.window, softcap=cfg.attn_softcap)
        new_kv = (k_cache, v_cache)
    o = o.reshape(B, T, H, hd)
    out = torch.einsum("btnh,nhd->btd", o, p["wo"].to(dt))
    return out, new_kv


def _mamba_apply(cfg: ModelConfig, p, x, cache=None):
    """Mamba2 block.  Returns (out, state): the prompt's final state, or
    the cache views updated in place for a decode step."""
    dt_ = dtype_of(cfg)
    B, T, D = x.shape
    h, hd = cfg.ssm_heads, cfg.ssm_head_dim
    xz = torch.einsum("btd,de->bte", x, p["w_x"].to(dt_))
    z = torch.einsum("btd,de->bte", x, p["w_z"].to(dt_))
    Bm = torch.einsum("btd,ds->bts", x, p["w_B"].to(dt_))
    Cm = torch.einsum("btd,ds->bts", x, p["w_C"].to(dt_))
    dt_raw = torch.einsum("btd,dh->bth", x, p["w_dt"].to(dt_))
    dtv = F.softplus(dt_raw.float() + p["dt_bias"].float())
    Aneg = -torch.exp(p["A_log"].float())

    w = cfg.conv_width
    if cache is None:
        # the conv tail comes from the *pre-activation* conv inputs
        new_cache = {"conv_x": xz[:, T - (w - 1):],
                     "conv_B": Bm[:, T - (w - 1):],
                     "conv_C": Cm[:, T - (w - 1):]}
        xc = F.silu(M2.causal_conv(xz, p["conv_x"].to(dt_)))
        Bc = F.silu(M2.causal_conv(Bm, p["conv_B"].to(dt_)))
        Cc = F.silu(M2.causal_conv(Cm, p["conv_C"].to(dt_)))
        xh = xc.reshape(B, T, h, hd)
        y, new_cache["h"] = M2.ssd_chunked(xh, dtv, Aneg, Bc, Cc,
                                           cfg.ssm_chunk)
    else:
        xt, cs_x = M2.conv_decode(xz[:, 0], cache["conv_x"], p["conv_x"].to(dt_))
        Bt, cs_B = M2.conv_decode(Bm[:, 0], cache["conv_B"], p["conv_B"].to(dt_))
        Ct, cs_C = M2.conv_decode(Cm[:, 0], cache["conv_C"], p["conv_C"].to(dt_))
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
    y = y + p["D_skip"].float()[None, None, :, None].to(y.dtype) * xh
    y = y.reshape(B, T, h * hd)
    gated = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = torch.einsum("bte,ed->btd", gated.to(dt_), p["w_out"].to(dt_))
    return out, new_cache


def _ffn_apply(cfg: ModelConfig, spec: LayerSpec, p, x):
    """Dense or MoE FFN.  Returns (out, aux_loss)."""
    dt = dtype_of(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.moe:
        y, aux = MOE.moe_ffn(cfg, x, p["router"], p["e_wi_g"].to(dt),
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
                 cache=None, cur_len=None):
    """One layer: (attn|mamba) + optional FFN, pre-norm residual.
    Returns (x, new_cache, aux)."""
    h_in = rms_norm(x, p["norm"], cfg.norm_eps)
    if spec.kind == "attn":
        mix, new_cache = _attn_apply(
            cfg, spec, p, h_in, cos, sin,
            cache_kv=None if cache is None else (cache["k"], cache["v"]),
            cur_len=cur_len)
        if cache is not None:
            new_cache = {"k": new_cache[0], "v": new_cache[1]}
    else:
        mix, new_cache = _mamba_apply(cfg, p, h_in, cache=cache)
    if cfg.sandwich_norm:
        mix = rms_norm(mix, p["post_norm"], cfg.norm_eps)
    x = x + mix

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.d_ff > 0:
        h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
        y, aux = _ffn_apply(cfg, spec, p, h2)
        if cfg.sandwich_norm:
            y = rms_norm(y, p["post_norm2"], cfg.norm_eps)
        x = x + y
    return x, new_cache, aux


def _logits(cfg: ModelConfig, params, x):
    dt = dtype_of(cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("btd,vd->btv", x, params["embed"].to(dt))
    else:
        logits = torch.einsum("btd,dv->btv", x, params["head"].to(dt))
    logits = logits.float()
    if cfg.final_softcap:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def _rope(cfg: ModelConfig, pos):
    return (A.rope_angles(cfg, pos) if cfg.rope_kind != "none"
            else (None, None))


def forward_hidden(cfg: ModelConfig, params, batch):
    """Run the layer stack.  Returns (hidden (B,T,D), aux_loss).

    Each stacked leaf is split once (``torch.unbind``): the backward of G
    slices is one stack, where indexing each group would write a zero
    tensor the size of the whole stack per group.  With ``cfg.remat`` and
    gradients on, each layer is checkpointed and recomputed in the
    backward."""
    x = _embed_inputs(cfg, params, batch)
    T = x.shape[1]
    cos, sin = _rope(cfg, _positions(cfg, batch, T))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = [{k: torch.unbind(v, 0) for k, v in p.items()}
              for p in params["blocks"]]

    def layer_fn(spec, p, x):
        x, _, a = _block_apply(cfg, spec, p, x, cos, sin)
        return x, a

    remat = cfg.remat and torch.is_grad_enabled()
    for g in range(cfg.num_groups):
        for spec, stack in zip(cfg.group, layers):
            p = {k: v[g] for k, v in stack.items()}
            if remat:
                x, a = checkpoint(layer_fn, spec, p, x, use_reentrant=False)
            else:
                x, a = layer_fn(spec, p, x)
            aux = aux + a
    return x, aux / cfg.num_layers


def forward_train(cfg: ModelConfig, params, batch):
    """Full-sequence forward.  Returns (logits (B,T,Vp) f32, aux_loss)."""
    x, aux = forward_hidden(cfg, params, batch)
    return _logits(cfg, params, x), aux


def _ce_terms(cfg: ModelConfig, params, x, labels):
    """(nll_sum, valid_count) of one chunk; its logits never escape.  The
    label's logit is gathered (the reference contracts a one-hot, which
    gives the same number)."""
    logits = _logits(cfg, params, x)
    valid = (labels >= 0) & (labels < cfg.vocab)
    labels_c = torch.clamp(labels, 0, cfg.vocab_padded - 1).long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels_c[..., None])[..., 0]
    nll = (logz - ll) * valid
    return nll.sum(), valid.sum()


def loss_fn(cfg: ModelConfig, params, batch, *, aux_weight: float = 0.01,
            ce_chunks: int = 8):
    """CE loss with the head and softmax chunked over T: one (B, T/chunks,
    V) logits block at a time, checkpointed (recomputed in the backward)
    when gradients are on, so the full (B, T, V) tensor never exists.
    Returns (loss + aux_weight * aux, (ce, aux))."""
    x, aux = forward_hidden(cfg, params, batch)
    labels = batch["labels"]
    T = x.shape[1]
    while T % ce_chunks:
        ce_chunks //= 2
    if ce_chunks <= 1:
        ns, nv = _ce_terms(cfg, params, x, labels)
    else:
        C = T // ce_chunks
        ns, nv = 0.0, 0
        for i in range(ce_chunks):
            xi, li = x[:, i * C:(i + 1) * C], labels[:, i * C:(i + 1) * C]
            if torch.is_grad_enabled():
                s, v = checkpoint(_ce_terms, cfg, params, xi, li,
                                  use_reentrant=False)
            else:
                s, v = _ce_terms(cfg, params, xi, li)
            ns, nv = ns + s, nv + v
    loss = ns / torch.clamp(nv, min=1)
    return loss + aux_weight * aux, (loss, aux)


# ===========================================================================
# Serving: cache init / prefill / decode
# ===========================================================================
def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Cache: per slot a dict of zero tensors stacked over groups (leading
    G dim), in the reference's layouts and dtypes."""
    dev = resolve_device(device)
    dt = dtype_of(cfg)
    G = cfg.num_groups
    K, hd = cfg.kv_heads, cfg.resolved_head_dim

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

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


def prefill(cfg: ModelConfig, params, batch, max_len: int):
    """Forward over a prompt, building the cache.  Returns (last_logits
    (B,1,Vp), cache, cur_len = T)."""
    x = _embed_inputs(cfg, params, batch)
    B, T, _ = x.shape
    cos, sin = _rope(cfg, _positions(cfg, batch, T))
    cache = init_cache(cfg, B, max_len, device=x.device)
    for g in range(cfg.num_groups):
        for spec, p, c in zip(cfg.group, params["blocks"], cache):
            x, nc, _ = _block_apply(cfg, spec, _slot(p, g), x, cos, sin)
            if spec.kind == "attn":
                c["k"][g, :, :T] = nc[0]
                c["v"][g, :, :T] = nc[1]
            else:
                for name, t in nc.items():
                    c[name][g] = t
    logits = _logits(cfg, params, x[:, -1:])
    return logits, cache, T


def decode_step(cfg: ModelConfig, params, cache, tokens, cur_len: int):
    """One decode step.  tokens: (B, 1) int; cur_len: length *including*
    the new token.  Returns (logits (B,1,Vp), cache), the cache updated in
    place."""
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
                                   cache=_slot(c, g), cur_len=cur_len)
    return _logits(cfg, params, x), cache
