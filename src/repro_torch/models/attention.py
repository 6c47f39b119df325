"""GQA attention: RoPE / M-RoPE, logit softcap, sliding window, blockwise
computation, and single-token decode against a KV cache.

The port's copy of `repro.models.attention`, in plain PyTorch ops (no
``scaled_dot_product_attention``: it has no softcap, and its numerics are
not the reference's).  Score and value products run in float32, as the
reference's ``preferred_element_type=float32`` einsums do: bf16 operands
are widened first, so each product is exact and every sum is float32.

Blockwise attention keeps the reference's static chunk pairs: q chunks are
a Python loop, and each q chunk visits only the causally (and window-)
reachable KV chunks, combining them with an online softmax in float32.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_angles(cfg: ModelConfig, positions):
    """positions: (B, T) int (std) or (B, T, 3) (mrope).
    Returns (cos, sin) of shape (B, T, hd/2) float32."""
    hd = cfg.resolved_head_dim
    half = hd // 2
    dev = positions.device
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, half, dtype=torch.float32, device=dev) / half))
    if cfg.rope_kind == "mrope":
        if positions.dim() == 2:
            positions = positions[..., None].expand(*positions.shape, 3)
        secs = cfg.mrope_sections
        assert sum(secs) == half, (secs, half)
        sec_id = torch.cat([torch.full((s,), i, dtype=torch.int64,
                                       device=dev)
                            for i, s in enumerate(secs)])          # (half,)
        pos = torch.gather(
            positions.float(), -1,
            sec_id.expand(*positions.shape[:-1], half))            # (B,T,half)
        ang = pos * inv_freq
    else:
        ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, T, ..., hd); cos/sin: (B, T, hd/2) or (1, T, hd/2), broadcast
    over the batch — rotate-half convention, in float32, result in x's
    dtype."""
    half = x.shape[-1] // 2
    shape = tuple(cos.shape[:2]) + (1,) * (x.dim() - 3) + (half,)
    c = cos.reshape(shape)
    s = sin.reshape(shape)
    xf = x.float()
    x1f, x2f = xf[..., :half], xf[..., half:]
    out = torch.cat([x1f * c - x2f * s, x2f * c + x1f * s], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Blockwise attention (training / prefill)
# ---------------------------------------------------------------------------
def _soft_cap(scores, cap: float):
    if cap and cap > 0:
        return torch.tanh(scores / cap) * cap
    return scores


def _auto_q_chunk(n: int) -> int:
    c = max(512, n // 8)
    return min(c, 2048, n)


def _auto_k_chunk(n: int) -> int:
    return min(1024, n)


def blockwise_attention(q, k, v, *, causal: bool, window: int = 0,
                        softcap: float = 0.0, q_chunk: int = 0,
                        k_chunk: int = 0, scale: float = 0.0):
    """q: (B, T, K, G, hd); k, v: (B, S, K, hd).  Returns (B, T, K, G, hd)
    in q's dtype.  ``scale`` multiplies the scores (0: 1/sqrt(hd)).

    Per q chunk, the KV chunks from the first one the window reaches to
    the last one causality reaches, each folded into an online softmax
    (running max, sum and float32 accumulator); one (q_chunk x k_chunk)
    score block at a time.
    """
    B, T, K, G, hd = q.shape
    S = k.shape[1]
    q_chunk = min(q_chunk or _auto_q_chunk(T), T)
    k_chunk = min(k_chunk or _auto_k_chunk(S), S)
    assert T % q_chunk == 0 and S % k_chunk == 0, (T, S, q_chunk, k_chunk)
    nq = T // q_chunk
    nk_total = S // k_chunk
    scale = scale or 1.0 / math.sqrt(hd)
    dev = q.device
    qf = q.float()

    out_chunks = []
    for i in range(nq):
        q_lo = i * q_chunk
        qi = qf[:, q_lo:q_lo + q_chunk]
        last = (min((q_lo + q_chunk - 1) // k_chunk, nk_total - 1)
                if causal else nk_total - 1)
        first = max(0, (q_lo - window) // k_chunk) if window else 0
        acc = torch.zeros((B, q_chunk, K, G, hd), dtype=torch.float32,
                          device=dev)
        m = torch.full((B, q_chunk, K, G), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, q_chunk, K, G), dtype=torch.float32, device=dev)
        qpos = q_lo + torch.arange(q_chunk, device=dev)[:, None]
        for j in range(first, last + 1):
            k_lo = j * k_chunk
            kj = k[:, k_lo:k_lo + k_chunk].float()
            vj = v[:, k_lo:k_lo + k_chunk]
            s = torch.einsum("btkgd,bskd->btkgs", qi, kj) * scale
            s = _soft_cap(s, softcap)
            if causal or window:
                kpos = k_lo + torch.arange(k_chunk, device=dev)[None, :]
                ok = torch.ones((q_chunk, k_chunk), dtype=torch.bool,
                                device=dev)
                if causal:
                    ok &= kpos <= qpos
                if window:
                    ok &= kpos >= qpos - window
                s = torch.where(ok[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            acc = acc * alpha[..., None] + torch.einsum(
                "btkgs,bskd->btkgd", p.to(v.dtype).float(), vj.float())
            l = l * alpha + p.sum(-1)
            m = m_new
        out_chunks.append(
            (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    return torch.cat(out_chunks, dim=1)


# ---------------------------------------------------------------------------
# Decode attention (single new token vs. cache)
# ---------------------------------------------------------------------------
def decode_attention(q, k_cache, v_cache, cur_len: int, *, window: int = 0,
                     softcap: float = 0.0, scale: float = 0.0):
    """q: (B, 1, K, G, hd); caches: (B, S, K, hd); cur_len: number of valid
    cache positions (including the token just written); ``scale`` as in
    :func:`blockwise_attention`."""
    hd = q.shape[-1]
    S = k_cache.shape[1]
    scale = scale or 1.0 / math.sqrt(hd)
    s = torch.einsum("bukgd,bskd->bkgs", q.float(), k_cache.float()) * scale
    s = _soft_cap(s, softcap)
    kpos = torch.arange(S, device=q.device)
    ok = kpos < cur_len
    if window:
        ok &= kpos >= cur_len - 1 - window
    s = torch.where(ok[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out[:, None].to(q.dtype)
