"""Mamba2 SSD (state-space duality) block: chunked parallel scan for
training/prefill, O(1) recurrent update for decode.

The port's copy of `repro.models.mamba2`.  Within a chunk (length L) the
output is an attention-like quadratic form masked by the cumulative decay;
across chunks a small recurrent state (B, heads, head_dim, state) is
carried by a loop.  All decay/softplus math runs in float32.

On real CUDA tensors the chunked scan, forward and backward, runs as
hand-written kernels (`repro_torch.kernels.ssd.ops`); CPU and fake
tensors (the dry run's) take the plain version here.
"""

from __future__ import annotations

import torch
from torch._guards import detect_fake_mode

from repro_torch.kernels.ssd.ops import ssd_kernel_apply


def causal_conv(u, w, b=None):
    """Depthwise causal conv.  u: (B, T, C); w: (W, C); b: (C,) or None.
    Returns (B, T, C).

    Written as W shifted multiply-adds in float32 rather than ``conv1d``:
    cuDNN would run a float32 convolution in TF32 on the card by default,
    and the reference's convolution is full float32.  The bias is added
    in float32 too, before the cast."""
    W, C = w.shape
    T = u.shape[1]
    uf = u.float()
    wf = w.float()
    pad = torch.nn.functional.pad(uf, (0, 0, W - 1, 0))    # causal left pad
    out = pad[:, 0:T] * wf[0]
    for i in range(1, W):
        out = out + pad[:, i:i + T] * wf[i]
    if b is not None:
        out = out + b.float()
    return out.to(u.dtype)


def conv_decode(u_t, conv_state, w):
    """One-step conv.  u_t: (B, C); conv_state: (B, W-1, C) past inputs.
    Returns (y_t, new_state)."""
    window = torch.cat([conv_state, u_t[:, None]], dim=1)     # (B, W, C)
    y = torch.einsum("bwc,wc->bc", window, w)
    return y, window[:, 1:]


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """SSD forward.

    x:  (B, T, H, P) value heads (f32 or bf16)
    dt: (B, T, H)    discretization steps (post-softplus, f32)
    A:  (H,)         negative decay rates (f32)
    Bm: (B, T, S)    input projections (shared across heads, ngroups=1)
    Cm: (B, T, S)    output projections
    h0: (B, H, P, S) initial state or None
    Returns (y: (B, T, H, P), h_final: (B, H, P, S)).

    Real CUDA tensors go to the kernels (which raise on a shape they do
    not take); CPU and fake tensors to :func:`ssd_chunked_plain`.
    """
    if x.is_cuda and detect_fake_mode((x,)) is None:
        return ssd_kernel_apply(x, dt, A, Bm, Cm, chunk, h0)
    return ssd_chunked_plain(x, dt, A, Bm, Cm, chunk, h0)


def ssd_chunked_plain(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """:func:`ssd_chunked` in plain PyTorch, on any device: the version
    the kernels are held to."""
    Bsz, T, H, P = x.shape
    S = Bm.shape[-1]
    L = min(chunk, T)
    assert T % L == 0, (T, L)
    NC = T // L

    xf = x.float()
    dtf = dt.float()
    dA = dtf * A                                             # (B, T, H)

    def ch(a):
        return a.reshape((Bsz, NC, L) + tuple(a.shape[2:]))

    x_c, dt_c, dA_c = ch(xf), ch(dtf), ch(dA)
    B_c, C_c = ch(Bm.float()), ch(Cm.float())

    A_cs = torch.cumsum(dA_c, dim=2)                         # (B,NC,L,H)
    A_end = A_cs[:, :, -1]                                   # (B,NC,H)

    # ---- intra-chunk (quadratic, attention-like) ----
    diff = A_cs[:, :, :, None, :] - A_cs[:, :, None, :, :]   # (B,NC,L,L,H)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    # masked before the exp: above the diagonal diff reaches hundreds at
    # published widths (dt up to 0.1, A to -16, 256 positions), where
    # exp overflows and its backward would give 0 * inf = NaN
    decay = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                  float("-inf")))
    cb = torch.einsum("bcls,bcms->bclm", C_c, B_c)           # (B,NC,L,L)
    scores = cb[..., None] * decay * dt_c[:, :, None, :, :]  # (B,NC,L,L,H)
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", scores, x_c)

    # ---- chunk states ----
    w_state = torch.exp(A_end[:, :, None, :] - A_cs) * dt_c  # (B,NC,L,H)
    states = torch.einsum("bclh,bcls,bclhp->bchps", w_state, B_c, x_c)

    # ---- inter-chunk recurrence ----
    h = (torch.zeros((Bsz, H, P, S), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    ys = []
    for c in range(NC):
        y_in = torch.einsum("bls,bhps->blhp", C_c[:, c], h)  # (B,L,H,P)
        ys.append(y_in * torch.exp(A_cs[:, c])[..., None])   # decay to pos l
        h = h * torch.exp(A_end[:, c])[:, :, None, None] + states[:, c]
    y_inter = torch.stack(ys, dim=1).reshape(Bsz, T, H, P)

    y = (y_intra.reshape(Bsz, T, H, P) + y_inter).to(x.dtype)
    return y, h


def ssd_decode(x_t, dt_t, A, B_t, C_t, h):
    """One-token recurrent update.

    x_t: (B, H, P); dt_t: (B, H); B_t/C_t: (B, S); h: (B, H, P, S).
    Returns (y_t: (B, H, P), h_next)."""
    xf = x_t.float()
    dtf = dt_t.float()
    decay = torch.exp(dtf * A)                               # (B, H)
    inc = torch.einsum("bh,bs,bhp->bhps", dtf, B_t.float(), xf)
    h_next = h * decay[:, :, None, None] + inc
    y = torch.einsum("bs,bhps->bhp", C_t.float(), h_next)
    return y.to(x_t.dtype), h_next
