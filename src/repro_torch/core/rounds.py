"""Shared round-function components for HERA, Rubato and PASTA (PyTorch).

The primitives :func:`repro_torch.core.schedule.execute_schedule` applies
in program order.  A keystream block's state is a (..., n) int64 vector in
Z_q, viewed row-major as ``branches`` (..., v, v) matrices (HERA/Rubato:
one branch; PASTA: two t-element branches with t = v²).

MRMC(X) = M_v·X·M_vᵀ runs as two back-to-back small shift-add matvecs
(`Modulus.matvec_small`) with no transpose materialized between them; it
commutes with transposition (MRMC(Xᵀ) = MRMC(X)ᵀ), which is what lets the
alternating schedule variant flip orientation for free.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.params import CipherParams


def ic_vector(params: CipherParams) -> np.ndarray:
    """Initial (public) state constant: (1, 2, ..., n) mod q."""
    return (np.arange(1, params.n + 1, dtype=np.uint32) % params.mod.q).astype(
        np.uint32
    )


def ark(params: CipherParams, x, key, rc, reduce_out: bool = True):
    """Add-round-key with randomized key schedule: x + k ⊙ rc (mod q).

    ``reduce_out=False`` (the reduction plan's defer-out flag) skips the
    output reduce: the raw sum, bounded by x's bound + q, flows into the
    next op's lazy accumulator.
    """
    mod = params.mod
    m = mod.mul(key, rc)
    return mod.add(x, m) if reduce_out else x + m


def _branch_view(params: CipherParams, x):
    """(..., n) state -> (..., branches, v, v) row-major branch matrices."""
    return x.reshape(x.shape[:-1] + (params.branches, params.v, params.v))


def mix_columns(params: CipherParams, x):
    """Y = M_v X per branch (the matrix multiplies the columns)."""
    X = _branch_view(params, x)
    Y = params.mod.matvec_small(params.mix_matrix(), X, axis=-2)
    return Y.reshape(x.shape)


def mix_rows(params: CipherParams, x):
    """Y = X M_vᵀ per branch (each row multiplied by M_v)."""
    X = _branch_view(params, x)
    Y = params.mod.matvec_small(params.mix_matrix(), X, axis=-1)
    return Y.reshape(x.shape)


def mrmc(params: CipherParams, x, in_bound: int | None = None,
         lazy: bool = False):
    """Fused MixRows∘MixColumns = M_v X M_vᵀ per branch.  ``lazy=True``
    (the plan's lazy-accumulate flag) runs both shift-add passes with raw
    terms and one terminal reduce per row, accepting operands up to
    ``in_bound`` on the first pass."""
    mod = params.mod
    M = params.mix_matrix()
    X = _branch_view(params, x)
    Y = mod.matvec_small(M, X, axis=-2, in_bound=in_bound, lazy=lazy)  # M X
    Z = mod.matvec_small(M, Y, axis=-1, lazy=lazy)   # (M X) M^T
    return Z.reshape(x.shape)


def mrmc_transposed(params: CipherParams, x_t):
    """MRMC of a transposed (column-major) state, per branch: by
    MRMC(Xᵀ) = MRMC(X)ᵀ it equals :func:`mrmc` on the stored array, the
    identity the alternating schedule variant relies on."""
    Xt = _branch_view(params, x_t).transpose(-1, -2)
    out = mrmc(params, Xt.reshape(x_t.shape))
    return _branch_view(params, out).transpose(-1, -2).reshape(x_t.shape)


def cube(params: CipherParams, x):
    """HERA nonlinearity: elementwise x^3 mod q."""
    return params.mod.cube(x)


def feistel(params: CipherParams, x, in_bound: int | None = None):
    """Type-3 Feistel, parallel form, per branch:

        y_1 = x_1;  y_i = x_i + x_{i-1}^2   (original x values)

    ``in_bound`` relaxes the operand contract: the square runs the
    bound-carrying multiply and the output add reduces from in_bound + q
    instead of 2q.
    """
    mod = params.mod
    b = params.branches
    in_b = mod.q if in_bound is None else in_bound
    X = x.reshape(x.shape[:-1] + (b, x.shape[-1] // b))
    if in_b <= mod.q:
        sq = mod.square(X[..., :-1])
        shifted = torch.cat([torch.zeros_like(X[..., :1]), sq], dim=-1)
        return mod.add(X, shifted).reshape(x.shape)
    sq = mod.mul(X[..., :-1], X[..., :-1], x_bound=in_b, y_bound=in_b)
    shifted = torch.cat([torch.zeros_like(X[..., :1]), sq], dim=-1)
    return mod.reduce(X + shifted, in_b + mod.q).reshape(x.shape)


def branch_mix(params: CipherParams, x, in_bound: int | None = None,
               lazy: bool = False):
    """PASTA branch mixing: (y_L, y_R) <- (2·y_L + y_R, y_L + 2·y_R) mod q,
    computed as s = y_L + y_R; (s + y_L, s + y_R).  ``lazy=True`` (the
    plan's fold-mix flag) folds the three reduces into ONE terminal reduce
    from 3·in_bound."""
    mod = params.mod
    t = x.shape[-1] // 2
    L, R_ = x[..., :t], x[..., t:]
    if lazy:
        in_b = mod.q if in_bound is None else in_bound
        s = L + R_
        out = torch.cat([s + L, s + R_], dim=-1)
        return mod.reduce(out, 3 * in_b)
    s = mod.add(L, R_)
    return torch.cat([mod.add(s, L), mod.add(s, R_)], dim=-1)


def agn(params: CipherParams, x, noise_signed):
    """Add discrete-Gaussian noise (signed) to (..., l) state."""
    mod = params.mod
    e = mod.from_signed(noise_signed.to(torch.int64))
    return mod.add(x, e)
