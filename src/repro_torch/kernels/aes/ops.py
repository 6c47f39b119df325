"""Wrappers for the CUDA AES kernel (csrc/aes.cu).

Each wrapper takes its plain PyTorch version (`kernels/aes/ref.py`) only
when its tensors lie on the CPU; for CUDA tensors it launches the kernel
or raises.  Launches are counted in `kernels.build.LAUNCHES`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.crypto.aes import _SBOX_NP
from repro_torch.kernels import build
from repro_torch.kernels.aes.ref import aes_ctr_ref, aes_xof_ref

_SBOX = {}


def _sbox(device):
    key = str(device)
    if key not in _SBOX:
        _SBOX[key] = torch.as_tensor(_SBOX_NP, dtype=torch.uint8,
                                     device=device)
    return _SBOX[key]


def _bytes(x, device, shape):
    """Byte operand (numpy or tensor) -> contiguous uint8 on device."""
    t = x if torch.is_tensor(x) else torch.as_tensor(np.array(x))
    t = t.to(device=device, dtype=torch.uint8).contiguous()
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"byte operand shape {tuple(t.shape)} != {shape}")
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
    ctr = build.u32_bits(counters).contiguous()
    lanes = ctr.shape[0]
    out = torch.empty((lanes, 16), dtype=torch.uint8, device=dev)
    lib = build.library()
    err = lib.repro_aes_ctr(_sbox(dev).data_ptr(), rk.data_ptr(),
                            n12.data_ptr(), ctr.data_ptr(), out.data_ptr(),
                            lanes, build.stream_handle(dev))
    build.check(err, "aes_ctr kernel")
    build.LAUNCHES["aes_ctr"] += 1
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
    sid = session_ids.to(device=dev, dtype=torch.int32).contiguous()
    ctr = build.u32_bits(block_ctrs).contiguous()
    lanes = ctr.shape[0]
    if sid.shape != ctr.shape:
        raise ValueError("session_ids / block_ctrs length mismatch")
    out = torch.empty((lanes, n_words), dtype=torch.int32, device=dev)
    lib = build.library()
    err = lib.repro_aes_xof(_sbox(dev).data_ptr(), rk_table.data_ptr(),
                            n12_table.data_ptr(), sid.data_ptr(),
                            ctr.data_ptr(), out.data_ptr(), lanes, n_words,
                            build.stream_handle(dev))
    build.check(err, "aes_xof kernel")
    build.LAUNCHES["aes_xof"] += 1
    return out
