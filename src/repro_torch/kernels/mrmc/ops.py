"""Wrapper for the CUDA MRMC kernel (csrc/mrmc.cu).

Public layout as in the reference: (lanes, n) row-major int64 states,
PASTA's branches each mixed by the same M_v.  A branch's v² words are
adjacent in that layout, so the kernel reads the caller's tensor where it
lies as a run of (v, v) states and writes a new row-major int64 tensor:
no permute, narrowing or widening copy (:func:`kernel_operands`).  CPU
tensors take the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.core.params import CipherParams
from repro_torch.kernels import build
from repro_torch.kernels.mrmc.ref import mrmc_ref


def kernel_operands(params: CipherParams, x):
    """The kernel's operand: the caller's (lanes, n) states as contiguous
    int64 — the same tensor when it already is one; a strided view or
    another dtype is converted once."""
    if x.dim() != 2 or x.shape[1] != params.n:
        raise ValueError(f"states shape {tuple(x.shape)} != (lanes, "
                         f"{params.n})")
    return x.to(torch.int64).contiguous()


def launch_mrmc(params: CipherParams, x):
    """Launch the kernel on :func:`kernel_operands`; returns a new
    row-major (lanes, n) int64 tensor."""
    build.require_cuda(x, "states", torch.int64, (x.shape[0], params.n))
    out = torch.empty_like(x)
    if not x.numel():
        return out
    q = params.mod.q
    lib = build.library()
    err = lib.repro_mrmc(params.v, x.data_ptr(), out.data_ptr(),
                         x.shape[0] * params.branches, q, (1 << 64) // q,
                         build.stream_handle(x.device))
    build.check(err, "mrmc kernel")
    build.count_launch("mrmc")
    return out


def mrmc_kernel_apply(params: CipherParams, x):
    """x: (lanes, n) int64 states in [0, q) -> (lanes, n) int64 MRMC
    output."""
    if not x.is_cuda:
        return mrmc_ref(params, x)
    return launch_mrmc(params, kernel_operands(params, x))
