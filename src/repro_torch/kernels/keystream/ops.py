"""Wrapper for the fused CUDA keystream kernel (csrc/keystream.cu).

:func:`op_table` flattens a (schedule, reduction plan) pair into the int32
op table the kernel interprets — one kernel binary per state size serves
every preset, variant and reduction mode.  :func:`keystream_kernel_apply`
has the reference's signature; CPU tensors take the plain version
(`kernels/keystream/ref.py`), CUDA tensors launch the kernel or raise.
:func:`keystream_kernel_sharded` splits the lanes over a list of devices
(the reference's mesh), and :func:`presto_keystream` is the producer ->
fused-kernel pipeline of one cipher.

Layout: the kernel reads the producer's row-major (lanes, words) int64
planes where they lie and writes the (lanes, l) int64 keystream the
engine returns, so the wrapper makes no copy on either side
(:func:`kernel_operands`).
"""

from __future__ import annotations

import contextlib
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


#: (V, branches, threads per lane, lanes per thread block) of each state
#: size's kernel instantiation: the same numbers as csrc/keystream.cu Shape.
KERNEL_SHAPE = {16: (4, 1, 16, 8), 32: (4, 2, 16, 8), 36: (6, 1, 64, 2),
                64: (8, 1, 64, 2), 128: (8, 2, 64, 1)}

_DEVICE_TABLES: dict = {}


def _device_table(params, variant, reduction, device):
    k = (params, variant, reduction, str(device))
    if k not in _DEVICE_TABLES:
        _DEVICE_TABLES[k] = torch.as_tensor(
            op_table(params, variant, reduction).copy(), device=device)
    return _DEVICE_TABLES[k]


def _plane(x, shape, name: str):
    """A (lanes, words) plane as the kernel reads it: contiguous int64 —
    the producer's own tensor, not a copy, when it already is one."""
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(x.shape)} != {tuple(shape)}")
    return x.to(torch.int64).contiguous()


def kernel_operands(params: CipherParams, key, rc, noise=None, *,
                    variant: str = "normal", mats=None) -> dict:
    """The kernel's operands: key (n,), rc (lanes, n_round_constants),
    noise (lanes, l) or None, mats (lanes, n_matrix_constants) or None —
    the producer's row-major int64 planes themselves (same storage; a
    plane of another dtype or a strided view is converted)."""
    sched = S.build_schedule(params, variant)
    lanes = rc.shape[0]
    n_mat = sched.n_matrix_constants
    ops = {"rc": _plane(rc, (lanes, sched.n_round_constants), "rc"),
           "noise": None, "mats": None}
    if noise is not None and params.n_noise:
        ops["noise"] = _plane(noise, (lanes, params.l), "noise")
    if n_mat:
        if mats is None:
            raise ValueError(f"schedule {sched.name} streams its affine "
                             "matrices: pass the mats plane")
        ops["mats"] = _plane(mats, (lanes, n_mat), "mats")
    key_d = torch.as_tensor(key).to(device=rc.device, dtype=torch.int64) \
        .contiguous()
    if key_d.shape != (params.n,):
        raise ValueError(f"key shape {tuple(key_d.shape)} != ({params.n},)")
    ops["key"] = key_d
    return ops


def launch_keystream(params: CipherParams, ops: dict, *,
                     variant: str = "normal",
                     reduction: str = DEFAULT_REDUCTION):
    """Launch the kernel on :func:`kernel_operands`; returns the
    row-major (lanes, l) int64 keystream."""
    sched = S.build_schedule(params, variant)
    rc_p = ops["rc"]
    dev = rc_p.device
    lanes = rc_p.shape[0]
    table = _device_table(params, variant, reduction, dev)
    noise_p, mats_p = ops["noise"], ops["mats"]
    n_mat = sched.n_matrix_constants
    build.require_cuda(rc_p, "rc", torch.int64,
                       (lanes, sched.n_round_constants))
    build.require_cuda(ops["key"], "key", torch.int64, (params.n,))
    if noise_p is not None:
        build.require_cuda(noise_p, "noise", torch.int64, (lanes, params.l))
    if n_mat:
        if mats_p is None:
            raise ValueError(f"schedule {sched.name} needs the mats plane")
        build.require_cuda(mats_p, "mats", torch.int64, (lanes, n_mat))
        if mats_p.data_ptr() % 16:
            raise ValueError("mats must be 16-byte aligned (cp.async)")
    out = torch.empty((lanes, params.l), dtype=torch.int64, device=dev)
    q = params.mod.q
    lib = build.library()
    err = lib.repro_keystream(
        params.n, table.data_ptr(), table.shape[0],
        1 if sched.init == "key" else 0, ops["key"].data_ptr(),
        rc_p.data_ptr(), sched.n_round_constants,
        noise_p.data_ptr() if noise_p is not None else None,
        mats_p.data_ptr() if mats_p is not None else None, n_mat,
        out.data_ptr(), params.l, lanes, q, (1 << 64) // q,
        build.stream_handle(dev))
    build.check(err, "keystream kernel")
    build.count_launch("keystream")
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
    ops = kernel_operands(params, key, rc, noise, variant=variant, mats=mats)
    return launch_keystream(params, ops, variant=variant, reduction=reduction)


def keystream_kernel_sharded(params: CipherParams, key, rc, noise=None, *,
                             devices=None, variant: str = "normal",
                             mats=None, reduction: str = DEFAULT_REDUCTION):
    """Lane-sharded fused consumer: :func:`keystream_kernel_apply` with
    its lanes split over ``devices``.

    The lanes are padded to a multiple of ``len(devices)`` with zero
    constants; rc, noise and mats are split into one slice per device and
    the key copied to each; each device runs the kernel on its slice on
    its current stream (CPU devices run the plain version); the slices
    are gathered on ``devices[0]`` and the padding trimmed.  There is no
    other traffic between devices.  A list may name one device more than
    once.  With ``devices`` None or of length 1 this is
    :func:`keystream_kernel_apply` (on ``devices[0]``).
    """
    devs = [torch.device(d) for d in (devices or [rc.device])]
    lanes = rc.shape[0]
    per = -(-lanes // len(devs))
    pad = per * len(devs) - lanes

    def split(x):
        if x is None:
            return [None] * len(devs)
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        return [x[i * per:(i + 1) * per] for i in range(len(devs))]

    key = torch.as_tensor(key)
    outs = []
    for d, rc_s, noise_s, mats_s in zip(devs, split(rc), split(noise),
                                        split(mats)):
        with torch.cuda.device(d) if d.type == "cuda" \
                else contextlib.nullcontext():
            outs.append(keystream_kernel_apply(
                params, key.to(d), rc_s.to(d),
                None if noise_s is None else noise_s.to(d),
                variant=variant,
                mats=None if mats_s is None else mats_s.to(d),
                reduction=reduction))
    if len(outs) == 1:
        return outs[0]
    return torch.cat([o.to(devs[0]) for o in outs])[:lanes]


def presto_keystream(cipher, block_ctrs):
    """The full pipeline for one :class:`~repro_torch.core.cipher.Cipher`:
    its producer (on the card, the ``aes_xof`` kernel and the samplers),
    then the fused consumer (on the card, the ``cuda`` engine's keystream
    kernel; on a CPU cipher, the ``ref`` engine).  Returns (lanes, l)
    int64 keystream."""
    from repro_torch.core.engine import make_engine  # engine imports us

    eng = make_engine("cuda" if cipher.device.type == "cuda" else "ref",
                      cipher.params, cipher.key, device=cipher.device)
    consts = cipher.round_constant_stream(block_ctrs)
    return eng.keystream_from_constants(consts["rc"], consts["noise"],
                                        consts.get("mats"))


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
