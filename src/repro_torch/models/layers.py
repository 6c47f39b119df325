"""Common layers: RMSNorm, gated MLP, initializers.

The port's copy of `repro.models.layers`, on torch tensors.  Weights are
cast to the compute dtype at each use, as the reference writes it; a
weight already held in that dtype (the serving model,
:meth:`repro_torch.models.model.Model.cast_for_serving`) is used as it is,
since ``Tensor.to`` returns the tensor itself when nothing changes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.constrain import wsc, wsc_grad
from repro_torch.models.sharding import P

#: the one-shot FFN stays below this many weight elements per matrix or
#: at this many tokens and fewer (the reference's thresholds)
CHUNK_MIN_ELEMS = 1 << 27
CHUNK_MIN_TOKENS = 1024


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def pdtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def rms_norm(x, scale, eps: float):
    """float32 statistics, ``1 + scale`` convention, result in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    # rebound, so that without autograd one float32 copy of x lives at once
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + scale.float())).to(x.dtype)


def mlp_shardings(shardings):
    """The dense MLP's layouts under a policy (None without one), from the
    activations' spec "acts" (B, T, D) of ``shardings``: "mlp_h", the
    hidden (B, T, F) and its gradient, laid out as "acts" (tokens as the
    activations, F over the model axes, as GSPMD derives it from ``wi``'s
    spec, by the rule of "ssm_inner"); "mlp_out", the output's gradient,
    tokens as "acts" and D whole (GSPMD gathers the reduce-scattered
    output's cotangent for the down projection's backward).  Under
    ``weight_stationary`` ``wi`` splits F over "data" too, but the tokens
    hold "data" (a mesh axis splits one dim of a tensor), so the hidden
    keeps the tokens' split and F the model axes alone.  "mlp_wi" and
    "mlp_wo", a chunk of the weights in :func:`chunked_gated_mlp`, and
    the one-shot path's weights under ``weight_stationary`` in a pass of
    more than ``CHUNK_MIN_TOKENS`` tokens: F over the model axes, D
    whole.  So stationary weights are gathered over "data" for a
    prefill, as GSPMD gathers them in the reference's (arctic-480b's
    dense up projections run ``65536x7168 @ 7168x304`` a rank, where
    DTensor ran them on D/8 and F whole, twice that share), and stay
    stationary in a decode step, where GSPMD gathers the tokens instead
    (``128x7168 @ 7168x19``).  A batch-1 decode step has no "acts"
    spec, and its MLP no constraint."""
    spec = shardings.get("acts") if shardings else None
    if spec is None:
        return None
    policy = shardings["_policy"]
    return {"mlp_h": spec, "mlp_out": P(*spec[:-1], None),
            "mlp_wi": P(None, policy.tp_full),
            "mlp_wo": P(policy.tp_full, None), "_policy": policy}


def mlp_down(h, o, mlp=None):
    """The down projection (..., F) @ (F, D) of a hidden, laid out by
    ``mlp`` (:func:`mlp_shardings`, or None)."""
    h = wsc(h, mlp, "mlp_h")
    return wsc_grad(torch.einsum("...f,fd->...d", h, o), mlp, "mlp_out")


def _swiglu(x, g, u, o, mlp=None):
    h = F.silu(torch.einsum("...d,df->...f", x, g)) * torch.einsum(
        "...d,df->...f", x, u)
    return mlp_down(h, o, mlp)


def gated_mlp(x, wi_g, wi_u, wo, shardings=None):
    """SwiGLU MLP.  x: (..., D); wi_*: (D, F); wo: (F, D).

    Above ``CHUNK_MIN_ELEMS`` weight elements and ``CHUNK_MIN_TOKENS``
    tokens the FFN runs in F-chunks into a float32 accumulator
    (:func:`chunked_gated_mlp`), as the reference does; its sums run in
    another order than the one-shot path's.

    Under a policy (``shardings``, from ``train_loop.act_shardings``) the
    hidden and the gradients are laid out by :func:`mlp_shardings`.  Left
    to DTensor, they depend on torch's version: on 2.11 the down
    projection ran with F whole on every "sp" rank (arctic-480b's
    prefill, twice its share), and its backward planned a layout whose
    view of the hidden raised (qwen2-vl-7b's 2-pod train step).
    """
    D, F_ = wi_g.shape
    n_tokens = x.numel() // x.shape[-1]
    if D * F_ <= CHUNK_MIN_ELEMS or n_tokens <= CHUNK_MIN_TOKENS:
        mlp = mlp_shardings(shardings)
        if mlp is not None and mlp["_policy"].weight_stationary \
                and n_tokens > CHUNK_MIN_TOKENS:
            wi_g, wi_u = (wsc(w, mlp, "mlp_wi") for w in (wi_g, wi_u))
            wo = wsc(wo, mlp, "mlp_wo")
        return _swiglu(x, wi_g, wi_u, wo, mlp)
    return chunked_gated_mlp(x, wi_g, wi_u, wo, shardings)


def chunked_gated_mlp(x, wi_g, wi_u, wo, shardings=None):
    """The F-chunked SwiGLU: up to 4 chunks of F (halved until they divide
    it), each chunk's product cast to float32 and summed in chunk order.

    Under a policy each chunk's hidden is laid out by "mlp_h" and each
    chunk of the weights by "mlp_wi"/"mlp_wo": a slice of F holds the
    ranks' shards of one part of F only, so DTensor gathers it, and left
    so every rank ran the chunk's products whole (jamba-1.5-large's
    prefill: 16x its share).  A chunk that does not split evenly over
    the model axes raises."""
    F_ = wi_g.shape[1]
    n_chunks = 4
    while F_ % n_chunks:
        n_chunks //= 2
    c = F_ // n_chunks
    mlp = mlp_shardings(shardings)
    if mlp is not None and c % mlp["_policy"].model_size:
        raise ValueError(f"an F-chunk of {c} does not split over the "
                         f"{mlp['_policy'].model_size} ranks of the model "
                         "axes")
    # the first chunk starts the sum: a plain zeros of x's shape would
    # count as replicated, the whole batch's float32 on every rank
    acc = None
    for i in range(n_chunks):
        s = slice(i * c, (i + 1) * c)
        g, u = (wsc(w[:, s], mlp, "mlp_wi") for w in (wi_g, wi_u))
        o = wsc(wo[s], mlp, "mlp_wo")
        y = _swiglu(x, g, u, o, mlp).float()
        acc = y if acc is None else acc + y
    return acc.to(x.dtype)


def normal_init(shape, dtype, generator, device, scale: float = 0.02):
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device) * scale).to(dtype)
