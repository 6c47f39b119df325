"""Wrappers for the CUDA AES kernel (csrc/aes.cu).

Each wrapper takes its plain PyTorch version (`kernels/aes/ref.py`) only
when its tensors lie on the CPU; for CUDA tensors it launches the kernel
or raises.  Launches are counted in `kernels.build.LAUNCHES`.

The kernel runs AES in T-table form: :func:`t_table` builds its one table
from the S-box, and :func:`xof_launch_shape` is its work mapping (the
same arithmetic as `repro_aes_xof`), so the CPU tests can model both.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.crypto.aes import _SBOX_NP
from repro_torch.kernels import build
from repro_torch.kernels.aes.ref import aes_ctr_ref, aes_xof_ref

#: threads per thread block of the XOF kernel (csrc/aes.cu kThreads)
XOF_THREADS = 256


def t_table() -> np.ndarray:
    """T0[x] = (2·S(x), S(x), S(x), 3·S(x)) as little-endian bytes of a
    uint32: one MixColumns column of a SubBytes output.  T1..T3 are T0
    rotated left by 8, 16 and 24 bits."""
    s = _SBOX_NP.astype(np.uint32)
    s2 = ((s << 1) & 0xFF) ^ (((s >> 7) & 1) * 0x1B)
    return (s2 | (s << 8) | (s << 16) | ((s2 ^ s) << 24)).astype(np.uint32)


def xof_launch_shape(lanes: int, n_words: int):
    """(AES blocks per lane, lanes per thread block, thread blocks) of the
    XOF kernel: a thread block covers one lane when the lane has at least
    XOF_THREADS AES blocks, else XOF_THREADS // n_blocks whole lanes."""
    n_blocks = (n_words + 3) // 4
    group = 1 if n_blocks >= XOF_THREADS else XOF_THREADS // n_blocks
    return n_blocks, group, (lanes + group - 1) // group


_TABLES = {}


def _t0(device):
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = torch.as_tensor(t_table().view(np.int32),
                                       device=device)
    return _TABLES[key]


def _bytes(x, device, shape):
    """Byte operand (numpy or tensor) -> contiguous uint8 on device."""
    t = x if torch.is_tensor(x) else torch.as_tensor(np.array(x))
    t = t.to(device=device, dtype=torch.uint8).contiguous()
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"byte operand shape {tuple(t.shape)} != {shape}")
    return t


def _lane_ints(x, device, name):
    """(lanes,) integer operand as contiguous int64 on device: the
    producer's own tensor when it already is one."""
    t = x.to(device=device, dtype=torch.int64).contiguous()
    if t.dim() != 1:
        raise ValueError(f"{name} must be 1-D (got shape {tuple(t.shape)})")
    return t


def aes_ctr_kernel_apply(round_keys, nonce12, counters):
    """AES(nonce12 || be32(counter)) per counter lane.

    round_keys: (11, 16) bytes; nonce12: (12,) bytes; counters: (lanes,)
    integer tensor of values in [0, 2^32).  Returns (lanes, 16) uint8."""
    if not counters.is_cuda:
        return aes_ctr_ref(round_keys, nonce12, counters)
    dev = counters.device
    rk = _bytes(round_keys, dev, (11, 16))
    n12 = _bytes(nonce12, dev, (12,))
    ctr = _lane_ints(counters, dev, "counters")
    lanes = ctr.shape[0]
    out = torch.empty((lanes, 16), dtype=torch.uint8, device=dev)
    lib = build.library()
    err = lib.repro_aes_ctr(_t0(dev).data_ptr(), rk.data_ptr(),
                            n12.data_ptr(), ctr.data_ptr(), out.data_ptr(),
                            lanes, build.stream_handle(dev))
    build.check(err, "aes_ctr kernel")
    build.count_launch("aes_ctr")
    return out


def aes_xof_words(rk_table, n12_table, session_ids, block_ctrs,
                  n_words: int):
    """Multi-session AES XOF words.

    rk_table: (S, 11, 16) uint8 expanded round keys per session;
    n12_table: (S, 12) uint8 nonce prefixes; session_ids: (lanes,) ints in
    [0, S); block_ctrs: (lanes,) counters < 2^16.  Returns (lanes, n_words)
    int32 bit patterns of the little-endian XOF words of block counters
    ctr·2^16 + i (i = 0 .. ceil(n_words/4) - 1)."""
    if not block_ctrs.is_cuda:
        return aes_xof_ref(rk_table, n12_table, session_ids, block_ctrs,
                           n_words)
    dev = block_ctrs.device
    S = rk_table.shape[0]
    build.require_cuda(rk_table, "rk_table", torch.uint8, (S, 11, 16))
    build.require_cuda(n12_table, "n12_table", torch.uint8, (S, 12))
    sid = _lane_ints(session_ids, dev, "session_ids")
    ctr = _lane_ints(block_ctrs, dev, "block_ctrs")
    lanes = ctr.shape[0]
    if sid.shape != ctr.shape:
        raise ValueError("session_ids / block_ctrs length mismatch")
    out = torch.empty((lanes, n_words), dtype=torch.int32, device=dev)
    lib = build.library()
    err = lib.repro_aes_xof(_t0(dev).data_ptr(), rk_table.data_ptr(),
                            n12_table.data_ptr(), sid.data_ptr(),
                            ctr.data_ptr(), out.data_ptr(), lanes, n_words,
                            build.stream_handle(dev))
    build.check(err, "aes_xof kernel")
    build.count_launch("aes_xof")
    return out
