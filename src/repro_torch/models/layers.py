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
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def _swiglu(x, g, u, o):
    h = F.silu(torch.einsum("...d,df->...f", x, g)) * torch.einsum(
        "...d,df->...f", x, u)
    return torch.einsum("...f,fd->...d", h, o)


def gated_mlp(x, wi_g, wi_u, wo):
    """SwiGLU MLP.  x: (..., D); wi_*: (D, F); wo: (F, D).

    Above ``CHUNK_MIN_ELEMS`` weight elements and ``CHUNK_MIN_TOKENS``
    tokens the FFN runs in F-chunks into a float32 accumulator
    (:func:`chunked_gated_mlp`), as the reference does; its sums run in
    another order than the one-shot path's.
    """
    D, F_ = wi_g.shape
    n_tokens = x.numel() // x.shape[-1]
    if D * F_ <= CHUNK_MIN_ELEMS or n_tokens <= CHUNK_MIN_TOKENS:
        return _swiglu(x, wi_g, wi_u, wo)
    return chunked_gated_mlp(x, wi_g, wi_u, wo)


def chunked_gated_mlp(x, wi_g, wi_u, wo):
    """The F-chunked SwiGLU: up to 4 chunks of F (halved until they divide
    it), each chunk's product cast to float32 and summed in chunk order."""
    F_ = wi_g.shape[1]
    n_chunks = 4
    while F_ % n_chunks:
        n_chunks //= 2
    c = F_ // n_chunks
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        s = slice(i * c, (i + 1) * c)
        acc = acc + _swiglu(x, wi_g[:, s], wi_u[:, s], wo[s]).float()
    return acc.to(x.dtype)


def normal_init(shape, dtype, generator, device, scale: float = 0.02):
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device) * scale).to(dtype)
