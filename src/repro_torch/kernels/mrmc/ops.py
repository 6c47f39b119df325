"""Wrapper for the CUDA MRMC kernel (csrc/mrmc.cu).

Public layout as in the reference: (lanes, n) row-major states.  Branches
fold into the kernel's column axis, so (lanes, b, v, v) becomes a
lane-major (v·v, lanes·b) plane; the kernel is oblivious to where lanes
end and branches begin.  CPU tensors take the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.core.params import CipherParams
from repro_torch.kernels import build
from repro_torch.kernels.mrmc.ref import mrmc_ref


def launch_mrmc(params: CipherParams, planes):
    """Launch the kernel on a contiguous lane-major (v·v, cols) int32
    plane (cols = lanes · branches); returns the same layout."""
    v = params.v
    build.require_cuda(planes, "planes", torch.int32,
                       (v * v, planes.shape[1]))
    out = torch.empty_like(planes)
    q = params.mod.q
    lib = build.library()
    err = lib.repro_mrmc(v, planes.data_ptr(), out.data_ptr(),
                         planes.shape[1], q, (1 << 64) // q,
                         build.stream_handle(planes.device))
    build.check(err, "mrmc kernel")
    build.count_launch("mrmc")
    return out


def lane_major_states(params: CipherParams, x):
    """(lanes, n) states -> contiguous (v·v, lanes·branches) int32."""
    lanes, n = x.shape
    if n != params.n:
        raise ValueError(f"state width {n} != n={params.n}")
    t = params.v * params.v
    return x.reshape(lanes, params.branches, t).permute(2, 0, 1) \
        .reshape(t, -1).to(torch.int32).contiguous()


def mrmc_kernel_apply(params: CipherParams, x):
    """x: (lanes, n) int64 states in [0, q) -> (lanes, n) int64 MRMC
    output."""
    if not x.is_cuda:
        return mrmc_ref(params, x)
    lanes, n = x.shape
    out = launch_mrmc(params, lane_major_states(params, x))
    return out.to(torch.int64).reshape(-1, lanes, params.branches) \
        .permute(1, 2, 0).reshape(lanes, n)
