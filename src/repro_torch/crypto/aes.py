"""AES-128 with a plain PyTorch block encryption.

The port's copy of `repro.crypto.aes`: the S-box and GF(2^8) tables are
derived (not typed in) at import with numpy, the key schedule runs
host-side in numpy, :func:`aes128_encrypt_blocks` is the plain torch
version of the CUDA AES kernel (`kernels/aes`), and
:func:`aes_ctr_keystream` runs that kernel's CTR entry.  A block is 16 bytes in
FIPS column-major state order: byte i is state[row=i%4, col=i//4].
"""

from __future__ import annotations

import numpy as np
import torch


# --------------------------------------------------------------------------
# GF(2^8) tables, derived at import time (numpy, host-side).
# --------------------------------------------------------------------------
def _gf_mul(a: int, b: int) -> int:
    p = 0
    for _ in range(8):
        if b & 1:
            p ^= a
        hi = a & 0x80
        a = (a << 1) & 0xFF
        if hi:
            a ^= 0x1B
        b >>= 1
    return p


def _build_sbox() -> np.ndarray:
    # multiplicative inverse via brute force, then the affine map
    inv = np.zeros(256, dtype=np.uint8)
    for x in range(1, 256):
        for y in range(1, 256):
            if _gf_mul(x, y) == 1:
                inv[x] = y
                break
    sbox = np.zeros(256, dtype=np.uint8)
    for x in range(256):
        b = int(inv[x])
        s = 0x63
        for i in range(8):
            bit = (
                (b >> i)
                ^ (b >> ((i + 4) % 8))
                ^ (b >> ((i + 5) % 8))
                ^ (b >> ((i + 6) % 8))
                ^ (b >> ((i + 7) % 8))
            ) & 1
            s ^= bit << i
        sbox[x] = s  # the 0x63 constant is folded in via the seed value of s
    return sbox


_SBOX_NP = _build_sbox()
assert _SBOX_NP[0x00] == 0x63 and _SBOX_NP[0x01] == 0x7C and _SBOX_NP[0x53] == 0xED, (
    "derived AES S-box failed spot check"
)

_RCON = np.array([0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36],
                 dtype=np.uint8)

# ShiftRows permutation on the flat 16-byte block (FIPS column-major order):
# state[r, c] <- state[r, (c + r) % 4];  flat index = r + 4*c.
_SHIFTROWS_PERM = np.array(
    [(r + 4 * ((c + r) % 4)) for c in range(4) for r in range(4)],
    dtype=np.int32,
)

SBOX = torch.as_tensor(_SBOX_NP)                 # (256,) uint8
SHIFTROWS_PERM = torch.as_tensor(_SHIFTROWS_PERM)  # (16,) int32


# --------------------------------------------------------------------------
# Key schedule (host-side numpy; round keys are static per cipher instance).
# --------------------------------------------------------------------------
def aes128_key_expand(key_bytes: np.ndarray) -> np.ndarray:
    """Expand a 16-byte key into 11 round keys, shape (11, 16) uint8."""
    key_bytes = np.asarray(key_bytes, dtype=np.uint8).reshape(16)
    words = [key_bytes[4 * i : 4 * i + 4].copy() for i in range(4)]
    for i in range(4, 44):
        t = words[i - 1].copy()
        if i % 4 == 0:
            t = np.roll(t, -1)
            t = _SBOX_NP[t]
            t[0] ^= _RCON[i // 4 - 1]
        words.append(words[i - 4] ^ t)
    rk = np.stack(words).reshape(11, 16)
    return rk


# --------------------------------------------------------------------------
# Block encryption (plain torch, batched).
# --------------------------------------------------------------------------
def _xtime(x):
    return ((x << 1) & 0xFF) ^ (((x >> 7) & 1) * 0x1B)


def _mix_columns(s):
    """MixColumns on (..., 16) flat state (column-major byte order)."""
    s = s.reshape(s.shape[:-1] + (4, 4))  # (..., col, row)
    a0, a1, a2, a3 = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    x0, x1, x2, x3 = _xtime(a0), _xtime(a1), _xtime(a2), _xtime(a3)
    b0 = x0 ^ (x1 ^ a1) ^ a2 ^ a3
    b1 = a0 ^ x1 ^ (x2 ^ a2) ^ a3
    b2 = a0 ^ a1 ^ x2 ^ (x3 ^ a3)
    b3 = (x0 ^ a0) ^ a1 ^ a2 ^ x3
    out = torch.stack([b0, b1, b2, b3], dim=-1)
    return out.reshape(out.shape[:-2] + (16,))


def aes128_encrypt_blocks(blocks, round_keys):
    """Encrypt (..., 16) byte blocks with round keys (..., 11, 16) that
    broadcast against the blocks' batch shape (one (11, 16) table, or one
    per block).  Bytes travel as int32 values in [0, 256); returns int32
    (..., 16) on the blocks' device."""
    dev = blocks.device
    sbox = torch.as_tensor(_SBOX_NP.astype(np.int32), device=dev)
    perm = torch.as_tensor(_SHIFTROWS_PERM.astype(np.int64), device=dev)
    rk = torch.as_tensor(round_keys, device=dev).to(torch.int32)
    s = blocks.to(torch.int32) ^ rk[..., 0, :]
    for rnd in range(1, 10):
        s = sbox[s.long()]
        s = s[..., perm]
        s = _mix_columns(s)
        s = s ^ rk[..., rnd, :]
    s = sbox[s.long()]
    s = s[..., perm]
    return s ^ rk[..., 10, :]


def aes_ctr_keystream(round_keys, nonce96, counter0: int, nblocks: int,
                      device=None):
    """AES-CTR keystream: (nblocks, 16) uint8 on ``device`` (None = the
    card).

    Counter block = nonce (12 bytes) || big-endian 32-bit counter, from
    ``counter0`` up, wrapping mod 2^32 as the reference's uint32 counter
    does.  On the card this is the CUDA AES kernel's CTR entry; on the
    CPU its plain version.
    """
    from repro_torch.device import resolve_device
    from repro_torch.kernels.aes.ops import aes_ctr_kernel_apply

    dev = resolve_device(device)
    nonce = np.asarray(nonce96, dtype=np.uint8).reshape(12)
    ctrs = torch.arange(counter0, counter0 + nblocks, dtype=torch.int64,
                        device=dev) & 0xFFFFFFFF
    return aes_ctr_kernel_apply(np.asarray(round_keys, np.uint8), nonce,
                                ctrs)
