"""Wrapper for the Mamba-2 SSD scan's CUDA kernels (csrc/ssd.cu).

:func:`ssd_kernel_apply` has the signature of the plain
`repro_torch.models.mamba2.ssd_chunked`, which calls it for real CUDA
tensors and keeps its own plain version for CPU and fake tensors.  The
forward and its backward are one `torch.autograd.Function`: the forward
saves the inputs and the state before each chunk (B, chunks, H, P, S) in
float32, never an (L, L, heads) tensor, and the backward is a second set
of kernels.  The kernels live in their own library
(`kernels.build.ssd_library`), built and loaded at the first call, so the
keystream path never builds it.  Launches are counted in
`kernels.build.LAUNCHES` as ``ssd_fwd`` and ``ssd_bwd``, once a call of
each direction; the backward runs inside an ``ssm.scan_bwd`` span.

What the kernels take: x, B and C all float32 or all bfloat16 (read in
that dtype and widened), P <= 64 and S <= 128, both multiples of 4, and a
chunk length L = min(chunk, T) <= 256 that divides T; anything else
raises.  dt, A and h0 are float32 (cast here, under autograd), y and the
gradients of x, B and C come back in x's dtype.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels import build

MAX_L, MAX_P, MAX_S = 256, 64, 128


def _shape_error(x, Bm, L, why):
    return ValueError(
        f"ssd kernel: no kernel for x {tuple(x.shape)} {x.dtype}, B/C "
        f"{tuple(Bm.shape)} {Bm.dtype}, chunk length {L}: {why} (it takes "
        f"P <= {MAX_P} and S <= {MAX_S}, multiples of 4, L <= {MAX_L} "
        "dividing T, x, B and C all float32 or all bfloat16)")


def _operand(t):
    """Contiguous, on a 16-byte boundary (the kernels' vector loads)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def ssd_kernel_apply(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """The SSD scan on the card, forward and backward.

    x: (B, T, H, P) float32 or bfloat16; dt: (B, T, H); A: (H,); Bm, Cm:
    (B, T, S) in x's dtype; h0: (B, H, P, S) or None.  Returns (y in x's
    dtype, h_final float32), as `ssd_chunked`."""
    if x.dim() != 4:
        raise ValueError(f"ssd kernel: x must be (B, T, H, P), got "
                         f"{tuple(x.shape)}")
    Bsz, T, H, P = x.shape
    S = Bm.shape[-1]
    L = min(chunk, T)
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise _shape_error(x, Bm, L, "dtypes")
    if L > MAX_L or T % L:
        raise _shape_error(x, Bm, L, "chunk length")
    if P > MAX_P or P % 4 or S > MAX_S or S % 4:
        raise _shape_error(x, Bm, L, "head or state width")
    for name, t, shape in (("dt", dt, (Bsz, T, H)), ("A", A, (H,)),
                           ("B", Bm, (Bsz, T, S)), ("C", Cm, (Bsz, T, S)),
                           ("h0", h0, (Bsz, H, P, S))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"ssd kernel: {name} shape {tuple(t.shape)} "
                             f"!= {shape}")
        if t is not None and t.device != x.device:
            raise ValueError(f"ssd kernel: {name} on {t.device}, x on "
                             f"{x.device}")
    if h0 is not None:
        h0 = _operand(h0.float())
    return _SSD.apply(_operand(x), _operand(dt.float()), _operand(A.float()),
                      _operand(Bm), _operand(Cm), h0, L)


def _call(what, err, lib):
    build.check(err, f"{what} kernels", lib)
    build.count_launch(what)


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, h0, L):
        lib = build.ssd_library()
        Bsz, T, H, P = x.shape
        S = Bm.shape[-1]
        f32 = dict(dtype=torch.float32, device=x.device)
        y = torch.empty_like(x)
        h_final = torch.empty((Bsz, H, P, S), **f32)
        chunk_h = torch.empty((Bsz, T // L, H, P, S), **f32)
        ws = torch.empty(lib.repro_ssd_workspace(Bsz, T, H, P, S, L, 0),
                         **f32)
        _call("ssd_fwd", lib.repro_ssd_fwd(
            int(x.dtype == torch.bfloat16), x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_final.data_ptr(), chunk_h.data_ptr(), ws.data_ptr(), Bsz, T,
            H, P, S, L, build.stream_handle(x.device)), lib)
        ctx.save_for_backward(x, dt, A, Bm, Cm, chunk_h)
        ctx.L = L
        ctx.set_materialize_grads(False)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, dt, A, Bm, Cm, chunk_h = ctx.saved_tensors
        L = ctx.L
        lib = build.ssd_library()
        Bsz, T, H, P = x.shape
        S = Bm.shape[-1]
        f32 = dict(dtype=torch.float32, device=x.device)
        dy = torch.zeros_like(x) if dy is None else _operand(dy.to(x.dtype))
        if dh_final is not None:
            dh_final = _operand(dh_final.float())
        with obs.span("ssm.scan_bwd", x):
            dx, dB, dC = (torch.empty_like(t) for t in (x, Bm, Cm))
            ddt = torch.empty_like(dt)
            dA_part = torch.empty((Bsz * (T // L), H), **f32)
            dh0 = (torch.empty((Bsz, H, P, S), **f32)
                   if ctx.needs_input_grad[5] else None)
            ws = torch.empty(lib.repro_ssd_workspace(Bsz, T, H, P, S, L, 1),
                             **f32)
            _call("ssd_bwd", lib.repro_ssd_bwd(
                int(x.dtype == torch.bfloat16), x.data_ptr(), dt.data_ptr(),
                A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                chunk_h.data_ptr(), dy.data_ptr(),
                None if dh_final is None else dh_final.data_ptr(),
                dx.data_ptr(), ddt.data_ptr(), dA_part.data_ptr(),
                dB.data_ptr(), dC.data_ptr(),
                None if dh0 is None else dh0.data_ptr(), ws.data_ptr(), Bsz,
                T, H, P, S, L, build.stream_handle(x.device)), lib)
            dA = dA_part.sum(0)
        return dx, ddt, dA, dB, dC, dh0, None
