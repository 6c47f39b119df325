"""AES-128 and the AES-128-CTR XOF, in plain numpy and PyTorch.

The benchmark's own copy, frozen: it imports nothing of the program.
The S-box is derived from GF(2^8) exponent tables (generator 3) and the
affine map of FIPS-197; the key schedule runs in numpy over many keys at
once; block encryption runs on int32 tensors on any device.

XOF (the ciphers' constants stream): under a 16-byte nonce ``nc`` the
words of cipher block counter ``ctr`` are AES-128 under the key ``nc`` of
the counter blocks ``nc[0:12] || be32(ctr * 2^16 + i)``, i = 0, 1, ...,
each 16-byte output read as four little-endian 32-bit words.
"""

from __future__ import annotations

import numpy as np
import torch

CTR_SPACE = 1 << 16


def _gf_tables():
    exp = np.zeros(255, np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        x ^= (x << 1) ^ (0x11B if x & 0x80 else 0)   # x * 3 in GF(2^8)
    log = np.zeros(256, np.int64)
    log[exp] = np.arange(255)
    return exp, log


def _sbox() -> np.ndarray:
    exp, log = _gf_tables()
    inv = np.zeros(256, np.int64)
    inv[1:] = exp[(255 - log[1:]) % 255]
    out = np.full(256, 0x63, np.int64)
    for k in range(5):                   # b ^ rotl(b,1..4)
        out ^= ((inv << k) | (inv >> (8 - k))) & 0xFF
    return out.astype(np.uint8)


SBOX = _sbox()
_RCON = np.array([1, 2, 4, 8, 16, 32, 64, 128, 27, 54], np.uint8)
# FIPS-197 byte i is state[row i % 4][column i // 4]; ShiftRows moves
# row r left by r columns.
_SHIFT = np.array([(i % 4) + 4 * (((i // 4) + (i % 4)) % 4)
                   for i in range(16)], np.int64)


def key_expand(keys) -> np.ndarray:
    """(S, 16) uint8 keys -> (S, 11, 16) uint8 round keys."""
    k = np.asarray(keys, np.uint8).reshape(-1, 16)
    w = [k[:, 4 * i:4 * i + 4].copy() for i in range(4)]
    for i in range(4, 44):
        t = w[i - 1]
        if i % 4 == 0:
            t = SBOX[np.roll(t, -1, axis=1)]
            t[:, 0] ^= _RCON[i // 4 - 1]
        w.append(w[i - 4] ^ t)
    return np.stack(w, axis=1).reshape(-1, 11, 16)


class AES:
    """Block encryption with per-block round keys, on one device."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.sbox = torch.as_tensor(SBOX.astype(np.int32), device=device)
        x2 = np.array([((b << 1) ^ (0x1B if b & 0x80 else 0)) & 0xFF
                       for b in range(256)], np.int32)
        self.mul2 = torch.as_tensor(x2, device=device)
        self.shift = torch.as_tensor(_SHIFT, device=device)

    def encrypt(self, blocks, rk):
        """blocks (..., 16) int32 byte values; rk (..., 11, 16) int32 round
        keys broadcasting against the blocks' batch shape -> (..., 16)."""
        s = blocks ^ rk[..., 0, :]
        for r in range(1, 11):
            s = self.sbox[s.long()][..., self.shift]
            if r < 10:
                a = s.view(s.shape[:-1] + (4, 4))      # (..., column, row)
                a2 = self.mul2[a.long()]
                s = (a2 ^ torch.roll(a2 ^ a, -1, -1) ^ torch.roll(a, -2, -1)
                     ^ torch.roll(a, -3, -1)).view(s.shape)
            s = s ^ rk[..., r, :]
        return s

    def xof_words(self, rk_table, nonce12, sid, ctr, n_words: int):
        """XOF words of lanes (session ``sid``, counter ``ctr``).

        rk_table: (S, 11, 16) int32 round keys, nonce12: (S, 12) int32
        byte values, both on this device; sid, ctr: (N,) int64.
        Returns (N, n_words) int64 word values in [0, 2^32)."""
        nb = -(-n_words // 4)
        n = sid.shape[0]
        i = torch.arange(nb, device=self.device)
        c = (ctr[:, None] * CTR_SPACE + i) & 0xFFFFFFFF        # (N, nb)
        be = torch.stack([(c >> s) & 0xFF for s in (24, 16, 8, 0)], -1)
        pre = nonce12[sid][:, None, :].expand(n, nb, 12)
        blocks = torch.cat([pre, be.to(torch.int32)], -1)      # (N, nb, 16)
        out = self.encrypt(blocks, rk_table[sid][:, None])
        b = out.to(torch.int64).view(n, nb * 4, 4)
        words = b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24
        return words[:, :n_words]
