"""Capacity-based top-k Mixture-of-Experts (GShard-style token choice).

The port's copy of `repro.models.moe`.  Dispatch is sort-based:
the (token, slot) -> expert assignments are flattened slot-major (so
first choices win capacity ties), stably sorted by expert id, and each
assignment's position inside its expert's capacity buffer is its rank
within the sorted run; ranks at or past ``capacity`` are dropped.  Nothing
of shape (N, E) is materialized beyond the router's probabilities.

:func:`moe_ffn_sharded` is the expert-parallel path over a
:class:`repro_torch.models.sharding.ShardingPolicy`: the reference's
``shard_map`` body on each rank's local shards, with explicit
``torch.distributed`` collectives whose adjoints are written out
(:class:`_AllGather`, :class:`_AllReduce`, :class:`_AllReduceShared`).

:func:`moe_ffn_held` is the port's own dropless layer over the experts
one device holds (granite-4.0-h-small's expert share): no capacity, a
grouped product over the held experts.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.configs.base import ModelConfig


def expert_counts(ids, E: int):
    """How many of ``ids`` (expert ids in [0, E)) name each expert:
    ``bincount(minlength=E)``'s numbers with a static output shape, so a
    traced pass over fake tensors (``launch.dryrun``) runs it too."""
    ids = ids.reshape(-1)
    return torch.zeros(E, dtype=torch.int64, device=ids.device).index_add_(
        0, ids, torch.ones_like(ids, dtype=torch.int64))


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
    f = expert_counts(e_slot, E).float() / (N * k)
    aux = E * torch.sum(f * probs.mean(0))

    return y.reshape(B, T, D).to(x.dtype), aux


def _held_groups(key, held: int):
    """The groups of a held-expert layer: the indices of the assignments
    to held experts (``key`` < ``held``; ``held`` names an expert held
    elsewhere) sorted by expert, stably, and each held expert's count,
    read on the host."""
    order = torch.argsort(key, stable=True)
    sizes = expert_counts(key, held + 1).tolist()[:held]
    return order[:sum(sizes)], sizes


def moe_ffn_held(cfg: ModelConfig, x, router_w, wi_g, wi_u, wo):
    """Dropless top-k MoE over the experts this device holds
    (``cfg.held_experts``): one expert-parallel rank's part of the layer,
    run without its exchange.  x: (B, T, D); router_w: (D, E) over all E
    experts; expert weights of the held ones: (E_held, D, F)/(E_held, F,
    D).

    The router scores every expert and keeps the k largest logits; the
    gates are the softmax over those k (the published gate: the softmax
    over all E renormalised over the k gives the same numbers, but its
    order of the k breaks down where the others' probabilities
    underflow).  Every assignment to a held expert is
    computed: the assignments are sorted by expert (stably, token order
    within one), each held expert multiplies its own rows in a grouped
    product, and the outputs are added into their tokens' rows times
    their gates, in float32.  Assignments to experts held elsewhere add
    nothing here.  The group sizes are read on the host once a call.

    Counters (`repro_torch.obs.count`): ``moe.routed``, the assignments
    to each held expert as the router made them, counted from its top-k
    apart from the groups (:func:`_held_groups`), and ``moe.computed``,
    the rows each held expert's product ran on.

    Returns (y (B, T, D) in x's dtype, aux), the aux loss as
    :func:`moe_ffn`'s over all E experts."""
    B, T, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    e0, held = cfg.held_experts
    N = B * T
    xf = x.reshape(N, D)
    with obs.span("moe.route", x):
        logits = xf.float() @ router_w.float()
        top, eidx = torch.topk(logits, k, dim=-1)             # (N, k)
        gates = torch.softmax(top, dim=-1)
        rel = eidx - e0
        mine = (rel >= 0) & (rel < held)
        # an expert held elsewhere sorts last, as "expert" held
        sel, sizes = _held_groups(torch.where(mine, rel, held).reshape(-1),
                                  held)
        rows, g = sel // k, gates.reshape(-1)[sel]
    if obs.counting():
        obs.count("moe.routed",
                  torch.bincount(rel[mine], minlength=held).tolist())
    with obs.span("moe.experts", x):
        xs = xf[rows]
        outs, done, at = [], [], 0
        for e in range(held):
            xe = xs[at:at + sizes[e]]
            h = F.silu(xe @ wi_g[e]) * (xe @ wi_u[e])
            outs.append(h @ wo[e])
            done.append(xe.shape[0])
            at += sizes[e]
        ye = torch.cat(outs)
        y = torch.zeros((N, D), dtype=torch.float32, device=x.device)
        y = y.index_add(0, rows, ye.float() * g[:, None])
    obs.count("moe.computed", done)

    # ---- load-balance aux loss (Switch): E * sum_e f_e * P_e ----
    f = expert_counts(eidx, E).float() / (N * k)
    aux = E * torch.sum(f * torch.softmax(logits, dim=-1).mean(0))
    return y.reshape(B, T, D).to(x.dtype), aux


# ---------------------------------------------------------------------------
# expert-parallel path (the reference's shard_map body)
# ---------------------------------------------------------------------------
def _all_gather(x, group, dim: int = 0):
    """Every rank's ``x`` of ``group`` concatenated along ``dim``."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _AllGather(torch.autograd.Function):
    """Concatenate every rank's ``x`` along ``dim`` over ``group``; the
    adjoint sums the gradients over the group and keeps this rank's slice
    (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, dim: int):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        n = dist.get_world_size(ctx.group)
        return g.chunk(n, dim=ctx.dim)[dist.get_rank(ctx.group)], None, None


class _AllReduceShared(torch.autograd.Function):
    """Sum ``x`` over ``group`` in ``dtype``, where each rank reads the sum
    in its own way (its own feature shard, its own tokens' rows): the
    gradient of its own term is every rank's gradient of the sum, summed
    (and cast back to ``x``'s dtype)."""

    @staticmethod
    def forward(ctx, x, group, dtype):
        ctx.group, ctx.dtype = group, x.dtype
        x = x.to(dtype, copy=True)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g.to(ctx.dtype), None, None


class _AllReduce(torch.autograd.Function):
    """Sum ``x`` over ``group``.  Every rank uses the sum as the same
    replicated value, so each receives the whole gradient of it, and the
    gradient of its own term is that gradient as it is."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _local_positions(e_local, k: int, n_loc: int, E: int, capacity: int):
    """Sort-based positions for the local token slice (slot-major
    priority).  Returns (pos (k, n_loc), keep (k, n_loc))."""
    e_flat = e_local.T.reshape(n_loc * k)
    e_sorted, order = torch.sort(e_flat, stable=True)
    starts = torch.searchsorted(
        e_sorted, torch.arange(E, device=e_local.device), side="left")
    rank_sorted = torch.arange(n_loc * k, device=e_local.device) \
        - starts[e_sorted]
    pos_flat = torch.empty_like(rank_sorted)
    pos_flat[order] = rank_sorted
    keep_flat = pos_flat < capacity
    return (torch.where(keep_flat, pos_flat, 0).reshape(k, n_loc),
            keep_flat.reshape(k, n_loc))


def moe_ffn_sharded(cfg: ModelConfig, x, router_w, wi_g, wi_u, wo, policy):
    """Expert-parallel MoE over the policy's mesh (DTensor inputs and
    outputs; the reference's ``moe_ffn_sharded``).

    Activations are dp-sharded and tp-replicated, so every expert owner
    already holds every local token: dispatch needs no communication.
    Each rank runs its ``E_loc`` experts (its coordinates on the expert
    axes) on its data shard's tokens, with capacity enforced per (expert,
    data shard), and ONE all-reduce over the tp axes sums the expert
    contributions and completes the feature-sharded matmuls.  Under FSDP
    the router and expert weights arrive data-sharded and are all-gathered
    in the body (the adjoint reduce-scatters their gradients).  The aux
    loss is averaged over dp.

    Under ``weight_stationary`` the expert features also split over
    "data" and the sum runs over "data" too, so the experts must see the
    same tokens on every "data" rank, where the reference keeps them
    data-sharded and sums products of different tokens (ROADMAP Queue
    3).  Each rank routes its own tokens (the router's product is
    GSPMD's share of the reference's) and gathers only their expert ids
    over "data"; positions are taken over the gathered ids, so the same
    tokens are kept and dropped as if all were routed together.  Each
    rank then writes its own tokens into the (E_loc, C, D) capacity
    buffer at their positions; the ranks' rows are disjoint, so the
    buffer's sum over "data" is every rank's dispatch, exactly.  The
    experts' float32 output partials are summed over "data" the same
    way, each rank combines its own tokens' rows, and the sum over the
    tp axes follows.  No rank holds a row of D for every token of
    "data": the buffer's C rows an expert are the capacity, k x
    capacity_factor / E of the gathered tokens.  The aux loss averages f
    and P over "data" before their product.

    Returns (y DTensor (B, T, D) in the input's batch layout, aux)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.sharding import run_local

    shape = policy.shape
    E, k = cfg.num_experts, cfg.top_k
    D = x.shape[-1]
    e_axes, f_axes = policy.expert_axes(cfg)
    e_axes, f_axes = tuple(e_axes or ()), tuple(f_axes or ())
    dp = policy.dp if not policy.seq_shard_data else ()
    fs = "data" if policy.fsdp else None
    tp_all = tuple(a for a in policy.tp_full if shape[a] > 1)
    # stationary weights: the features' partial sums span "data" too, and
    # tokens split over "data" meet in the capacity buffer
    data_sum = policy.weight_stationary and shape["data"] > 1
    own = data_sum and "data" in dp
    if policy.weight_stationary:
        f_axes = f_axes + ("data",)
    psum_axes = tp_all + (("data",) if data_sum and not own else ())
    mean_axes = tuple(a for a in dp if shape[a] > 1
                      and not (own and a == "data"))
    e_loc = E // math.prod(shape[a] for a in e_axes)

    # chunk the expert FFN features when the gathered weights would
    # otherwise dominate residency (the reference's rule)
    f_loc = cfg.d_ff // math.prod(shape[a] for a in f_axes)
    n_f_chunks = 1
    while e_loc * D * (f_loc // n_f_chunks) > 2**28 and n_f_chunks < 8:
        n_f_chunks *= 2
    while f_loc % n_f_chunks:
        n_f_chunks //= 2

    lin = 0
    for a in e_axes:
        lin = lin * shape[a] + policy.coord(a)
    e0 = lin * e_loc
    n_red = math.prod(shape[a] for a in psum_axes)
    gather = (lambda w, dim: _AllGather.apply(w, policy.group(fs), dim)
              ) if fs and shape[fs] > 1 else (lambda w, dim: w)

    def body(xb, rw, wg, wu, wod):
        # xb: (B_loc, T, D); rw: (D/fs, E); w*: (E_loc, D/fs, F_loc)
        n_own = xb.shape[0] * xb.shape[1]
        xf = xb.reshape(n_own, D)
        rw = gather(rw, 0)
        logits = xf.float() @ rw.float()
        probs = torch.softmax(logits, dim=-1)
        gates, eidx = torch.topk(probs, k, dim=-1)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        # load-balance aux's f and P on this rank's tokens
        f = expert_counts(eidx, E).float() / (n_own * k)
        p_mean = probs.mean(0)
        ids = eidx
        if own:
            grp = policy.group("data")
            ids = _all_gather(eidx, grp)       # every "data" rank's ids
            f = _AllReduce.apply(f, grp) / shape["data"]
            p_mean = _AllReduce.apply(p_mean, grp) / shape["data"]
        n_loc = ids.shape[0]
        capacity = max(1, math.ceil(n_loc * k * cfg.capacity_factor / E))
        pos, keep = _local_positions(ids, k, n_loc, E, capacity)
        if own:                               # this rank's tokens' rows
            r0 = dist.get_rank(grp) * n_own
            pos, keep = pos[:, r0:r0 + n_own], keep[:, r0:r0 + n_own]

        mine, e_rel = [], []
        xe = torch.zeros((e_loc, capacity, D), dtype=xb.dtype,
                         device=xb.device)
        for s in range(k):
            r = eidx[:, s] - e0
            m = keep[s] & (r >= 0) & (r < e_loc)
            r = torch.where(m, r, 0)
            mine.append(m)
            e_rel.append(r)
            contrib = torch.where(m[:, None], xf, torch.zeros_like(xf))
            xe = xe.index_put((r, pos[s]), contrib, accumulate=True)
        if own:               # the ranks' rows are disjoint: the sum is xe
            xe = _AllReduceShared.apply(xe, grp, xe.dtype)

        def ffn(xe, g_, u_, o_):
            h = F.silu(torch.bmm(xe, gather(g_, 1))) * torch.bmm(
                xe, gather(u_, 1))
            return torch.bmm(h, gather(o_, 2))

        if n_f_chunks > 1:
            ye = torch.zeros((e_loc, capacity, D), dtype=torch.float32,
                             device=xb.device)
            for g_, u_, o_ in zip(wg.chunk(n_f_chunks, 2),
                                  wu.chunk(n_f_chunks, 2),
                                  wod.chunk(n_f_chunks, 1)):
                part = (checkpoint(ffn, xe, g_, u_, o_, use_reentrant=False)
                        if torch.is_grad_enabled() else ffn(xe, g_, u_, o_))
                ye = ye + part.float()
            ye = ye.to(xb.dtype)
        else:
            ye = ffn(xe, wg, wu, wod)                 # (E_loc, C, D)

        if own:                               # "data"'s feature partials
            ye = _AllReduceShared.apply(ye, grp, torch.float32)
        y = torch.zeros((n_own, D), dtype=torch.float32, device=xb.device)
        for s in range(k):
            part = ye[e_rel[s], pos[s]].float()
            y = y + part * (gates[:, s] * mine[s])[:, None]
        for a in psum_axes:                   # experts + feature partials
            y = _AllReduce.apply(y, policy.group(a))

        # load-balance aux (local f/P are unbiased estimates; mean over dp)
        aux = E * torch.sum(f * p_mean)
        for a in mean_axes:
            aux = _AllReduce.apply(aux, policy.group(a)) / shape[a]
        # every rank of the summed axes computes the same aux: count its
        # gradient once across them
        aux = aux / n_red + (aux - aux / n_red).detach()
        return y.reshape(xb.shape).to(xb.dtype), aux

    x_pl = policy.placements((dp or None, None, None))
    w_in = policy.placements((e_axes or None, fs, f_axes or None))
    w_out = policy.placements((e_axes or None, f_axes or None, fs))
    for t in (x, router_w, wi_g, wi_u, wo):
        if not isinstance(t, DTensor):
            raise TypeError("moe_ffn_sharded takes DTensors on the "
                            "policy's mesh")
    # the body splits tokens and experts across every replica
    return run_local(body, policy, [
        (x, x_pl), (router_w, policy.placements((fs, None))),
        (wi_g, w_in), (wi_u, w_in), (wo, w_out)],
        [x_pl, policy.placements(())], split=policy.mesh_axes)
