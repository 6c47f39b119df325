"""Capacity-based top-k Mixture-of-Experts (GShard-style token choice).

The port's copy of `repro.models.moe.moe_ffn`.  Dispatch is sort-based:
the (token, slot) -> expert assignments are flattened slot-major (so
first choices win capacity ties), stably sorted by expert id, and each
assignment's position inside its expert's capacity buffer is its rank
within the sorted run; ranks at or past ``capacity`` are dropped.  Nothing
of shape (N, E) is materialized beyond the router's probabilities.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def route(cfg: ModelConfig, xf, router_w):
    """Router and capacity positions.  xf: (N, D); router_w: (D, E).

    Returns (probs (N, E), gates (N, k), e_slot (k, N), pos (k, N),
    keep (k, N), capacity): ``e_slot[s, n]`` is token n's s-th expert,
    ``pos`` its row in that expert's buffer (0 where dropped)."""
    N = xf.shape[0]
    E, k = cfg.num_experts, cfg.top_k
    logits = xf.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                    # (N, E)
    gates, eidx = torch.topk(probs, k, dim=-1)               # (N, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    capacity = max(1, math.ceil(N * k * cfg.capacity_factor / E))

    # ---- sort-based positions: slot-major flatten => first choices win ----
    e_flat = eidx.T.reshape(N * k)
    e_sorted, order = torch.sort(e_flat, stable=True)
    starts = torch.searchsorted(
        e_sorted, torch.arange(E, device=xf.device), side="left")
    rank_sorted = torch.arange(N * k, device=xf.device) - starts[e_sorted]
    pos_flat = torch.empty_like(rank_sorted)
    pos_flat[order] = rank_sorted
    keep_flat = pos_flat < capacity
    pos_flat = torch.where(keep_flat, pos_flat, 0)
    return (probs, gates, eidx.T, pos_flat.reshape(k, N),
            keep_flat.reshape(k, N), capacity)


def moe_ffn(cfg: ModelConfig, x, router_w, wi_g, wi_u, wo):
    """x: (B, T, D).  router_w: (D, E).  expert weights: (E, D, F)/(E, F, D).

    Returns (y, aux_loss)."""
    B, T, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    N = B * T
    xf = x.reshape(N, D)
    probs, gates, e_slot, pos, keep, capacity = route(cfg, xf, router_w)

    # ---- dispatch into (E, C, D) buffers ----
    xe = torch.zeros((E, capacity, D), dtype=x.dtype, device=x.device)
    for s in range(k):
        contrib = torch.where(keep[s][:, None], xf, torch.zeros_like(xf))
        xe.index_put_((e_slot[s], pos[s]), contrib, accumulate=True)

    # ---- expert FFN (SwiGLU), dense per-expert batches ----
    h = F.silu(torch.bmm(xe, wi_g)) * torch.bmm(xe, wi_u)
    ye = torch.bmm(h, wo)                                    # (E, C, D)

    # ---- combine ----
    y = torch.zeros((N, D), dtype=torch.float32, device=x.device)
    for s in range(k):
        part = ye[e_slot[s], pos[s]].float()
        w = (gates[:, s] * keep[s])[:, None]
        y = y + part * w

    # ---- load-balance aux loss (Switch): E * sum_e f_e * P_e ----
    f = torch.bincount(e_slot.reshape(-1), minlength=E).float() / (N * k)
    aux = E * torch.sum(f * probs.mean(0))

    return y.reshape(B, T, D).to(x.dtype), aux
