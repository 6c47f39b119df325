"""Wrapper for the fused CUDA keystream kernel (csrc/keystream.cu).

:func:`op_table` flattens a (schedule, reduction plan) pair into the int32
op table the kernel interprets — one kernel binary per state size serves
every preset, variant and reduction mode.  :func:`keystream_kernel_apply`
has the reference's signature; CPU tensors take the plain version
(`kernels/keystream/ref.py`), CUDA tensors launch the kernel or raise.

Layout: the producer emits row-major (lanes, words) planes; the kernel
reads lane-major (words, lanes) planes in the producer's logical word
order (it applies the storage-order permutations to the word index
itself), so each plane costs the wrapper one copy: the transpose and the
int64 -> int32 narrowing in a single ``copy_``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import redplan as RP
from repro_torch.core import schedule as S
from repro_torch.core.params import CipherParams
from repro_torch.core.redplan import DEFAULT_REDUCTION
from repro_torch.kernels import build
from repro_torch.kernels.keystream.ref import keystream_ref

# op kinds and flags: the same constants as csrc/keystream.cu
OP_ARK, OP_MRMC, OP_NONLINEAR, OP_TRUNCATE, OP_AGN = range(5)
F_T_IN = 1
F_T_OUT = 2
F_HAS_RC = 4
F_MIX = 8
F_STREAM = 16
F_FEISTEL = 32
F_DEFER_OUT = 64
F_LAZY_ACC = 128
F_LAZY_DENSE = 256
F_FOLD_MIX = 512
REC = 8
R_KIND, R_FLAGS, R_RC_A, R_LEN, R_MAT_A, R_KEEP = range(6)

_PLAN_FLAGS = {RP.DEFER_OUT: F_DEFER_OUT, RP.LAZY_ACCUMULATE: F_LAZY_ACC,
               RP.LAZY_DENSE: F_LAZY_DENSE, RP.FOLD_MIX: F_FOLD_MIX}


@functools.lru_cache(maxsize=None)
def op_table(params: CipherParams, variant: str = "normal",
             reduction: str = DEFAULT_REDUCTION) -> np.ndarray:
    """(n_ops, REC) int32 records: kind, flags, rc start, rc/key length,
    matrix-plane start, truncate keep."""
    sched = S.build_schedule(params, variant)
    plan = RP.plan_reductions(params, sched, reduction).validate(sched)
    rows = np.zeros((len(sched.ops), REC), np.int32)
    for i, op in enumerate(sched.ops):
        r = rows[i]
        f = 0
        if op.orientation == S.TRANSPOSED:
            f |= F_T_IN
        for flag in plan.ops[i].flags:
            f |= _PLAN_FLAGS[flag]
        if isinstance(op, S.ARK):
            r[R_KIND] = OP_ARK
            r[R_RC_A], r[R_LEN] = op.rc_slice[0], op.key_len
        elif isinstance(op, S.MRMC):
            r[R_KIND] = OP_MRMC
            if op.out_orientation == S.TRANSPOSED:
                f |= F_T_OUT
            if op.has_rc:
                f |= F_HAS_RC
                r[R_RC_A] = op.rc_slice[0]
                r[R_LEN] = op.rc_slice[1] - op.rc_slice[0]
            if op.mix_branches:
                f |= F_MIX
            if op.streams_matrix:
                f |= F_STREAM
                r[R_MAT_A] = op.mat_slice[0]
        elif isinstance(op, S.NONLINEAR):
            r[R_KIND] = OP_NONLINEAR
            if op.kind == "feistel":
                f |= F_FEISTEL
        elif isinstance(op, S.TRUNCATE):
            r[R_KIND] = OP_TRUNCATE
            r[R_KEEP] = op.keep
        elif isinstance(op, S.AGN):
            r[R_KIND] = OP_AGN
        r[R_FLAGS] = f
    rows.setflags(write=False)
    return rows


_DEVICE_TABLES: dict = {}


def _device_table(params, variant, reduction, device):
    k = (params, variant, reduction, str(device))
    if k not in _DEVICE_TABLES:
        _DEVICE_TABLES[k] = torch.as_tensor(
            op_table(params, variant, reduction).copy(), device=device)
    return _DEVICE_TABLES[k]


def _lane_major(x, rows: int, lanes: int, name: str):
    """(lanes, rows) int tensor -> contiguous (rows, lanes) int32: one
    copy doing the transpose and the narrowing together."""
    if tuple(x.shape) != (lanes, rows):
        raise ValueError(f"{name} shape {tuple(x.shape)} != {(lanes, rows)}")
    out = torch.empty((rows, lanes), dtype=torch.int32, device=x.device)
    out.copy_(x.T)
    return out


def lane_major_inputs(params: CipherParams, key, rc, noise=None, *,
                      variant: str = "normal", mats=None) -> dict:
    """The kernel's operands from row-major producer planes: key (n,),
    rc (n_round_constants, lanes), noise (l, lanes) or None, mats
    (n_matrix_constants, lanes) or None — all contiguous int32 on rc's
    device, one copy per plane."""
    sched = S.build_schedule(params, variant)
    lanes = rc.shape[0]
    n_mat = sched.n_matrix_constants
    planes = {"rc": _lane_major(rc, sched.n_round_constants, lanes, "rc"),
              "noise": None, "mats": None}
    if noise is not None and params.n_noise:
        planes["noise"] = _lane_major(noise, params.l, lanes, "noise")
    if n_mat:
        if mats is None:
            raise ValueError(f"schedule {sched.name} streams its affine "
                             "matrices: pass the mats plane")
        planes["mats"] = _lane_major(mats, n_mat, lanes, "mats")
    key_d = torch.as_tensor(key).to(device=rc.device, dtype=torch.int32) \
        .contiguous()
    if key_d.shape != (params.n,):
        raise ValueError(f"key shape {tuple(key_d.shape)} != ({params.n},)")
    planes["key"] = key_d
    return planes


def launch_keystream(params: CipherParams, planes: dict, *,
                     variant: str = "normal",
                     reduction: str = DEFAULT_REDUCTION):
    """Launch the kernel on :func:`lane_major_inputs` operands; returns the
    lane-major (l, lanes) int32 keystream."""
    sched = S.build_schedule(params, variant)
    rc_p = planes["rc"]
    dev = rc_p.device
    lanes = rc_p.shape[1]
    table = _device_table(params, variant, reduction, dev)
    noise_p, mats_p = planes["noise"], planes["mats"]
    build.require_cuda(rc_p, "rc", torch.int32,
                       (sched.n_round_constants, lanes))
    build.require_cuda(planes["key"], "key", torch.int32, (params.n,))
    if noise_p is not None:
        build.require_cuda(noise_p, "noise", torch.int32, (params.l, lanes))
    if sched.n_matrix_constants:
        if mats_p is None:
            raise ValueError(f"schedule {sched.name} needs the mats plane")
        build.require_cuda(mats_p, "mats", torch.int32,
                           (sched.n_matrix_constants, lanes))
    out = torch.empty((params.l, lanes), dtype=torch.int32, device=dev)
    q = params.mod.q
    lib = build.library()
    err = lib.repro_keystream(
        params.n, table.data_ptr(), table.shape[0],
        1 if sched.init == "key" else 0, planes["key"].data_ptr(),
        rc_p.data_ptr(),
        noise_p.data_ptr() if noise_p is not None else None,
        mats_p.data_ptr() if mats_p is not None else None,
        out.data_ptr(), params.l, lanes, q, (1 << 64) // q,
        build.stream_handle(dev))
    build.check(err, "keystream kernel")
    build.LAUNCHES["keystream"] += 1
    return out


def keystream_kernel_apply(params: CipherParams, key, rc, noise=None, *,
                           variant: str = "normal", mats=None,
                           reduction: str = DEFAULT_REDUCTION):
    """key: (n,) ints in Z_q; rc: (lanes, n_round_constants) int64; noise:
    (lanes, l) signed ints or None; mats: (lanes, n_matrix_constants)
    int64 or None.  Returns (lanes, l) int64 keystream, bit-exact with
    :func:`keystream_ref` for either variant and reduction mode."""
    if not rc.is_cuda:
        return keystream_ref(params, key, rc, noise, variant=variant,
                             mats=mats, reduction=reduction)
    planes = lane_major_inputs(params, key, rc, noise, variant=variant,
                               mats=mats)
    out = launch_keystream(params, planes, variant=variant,
                           reduction=reduction)
    return out.T.to(torch.int64).contiguous()


def work_per_lane(params: CipherParams, variant: str = "normal") -> dict:
    """Arithmetic one keystream lane needs, counted off the schedule:
    full modular products, modular adds, small-constant multiply-adds of
    the static mix, and multiply-adds of the dense streamed matrices."""
    sched = S.build_schedule(params, variant)
    v, b = params.v, params.branches
    t = v * v
    w = {"modmul": 0, "modadd": 0, "mac_small": 0, "mac_dense": 0,
         "reduce": 0}
    width = params.n
    for op in sched.ops:
        if isinstance(op, S.ARK):
            w["modmul"] += op.key_len
            w["modadd"] += op.key_len
        elif isinstance(op, S.MRMC):
            if op.streams_matrix:
                w["mac_dense"] += b * t * t
                w["reduce"] += b * t
            else:
                w["mac_small"] += b * 2 * v * v * v
                w["reduce"] += b * 2 * v * v
            if op.has_rc:
                w["modadd"] += width
            if op.mix_branches:
                w["modadd"] += 3 * t
        elif isinstance(op, S.NONLINEAR):
            if op.kind == "cube":
                w["modmul"] += 2 * width
            else:
                w["modmul"] += b * (t - 1)
                w["modadd"] += b * (t - 1)
        elif isinstance(op, S.TRUNCATE):
            width = op.keep
        elif isinstance(op, S.AGN) and params.n_noise:
            w["modadd"] += params.l
    return w
