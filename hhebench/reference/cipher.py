"""HERA and Rubato keystream, and the fixed-point boundary, in plain
PyTorch: the reference that decides whether a run is correct.

The benchmark's own copy, frozen: it imports nothing of the program and
takes nothing the program made.  Everything comes from a configuration
file (``hhebench/configs/<name>.json``) and from the inputs the harness
made: the key, the nonces, the block counters and the payloads.

HERA (Cho et al., ASIACRYPT 2021), on a state of n = v*v words of Z_q:

    x = ic;  x = ARK_0(x)
    r - 1 times:  x = ARK_i(Cube(MRMC(x)))
    x = ARK_r(MRMC(Cube(MRMC(x))))

Rubato (Ha et al., EUROCRYPT 2022), Feistel in place of Cube, and after
the last MRMC the state is truncated to l words before ARK_r and the
discrete Gaussian noise is added.  ic = (1, ..., n) mod q; ARK_i(x) =
x + key * rc_i with the i-th n (last: l) round constants; MRMC(X) = M X
M^T with M the circulant of first row (2, 3, 1, ..., 1); Cube(x) = x^3;
Feistel(x)_0 = x_0, Feistel(x)_i = x_i + x_{i-1}^2.  Every value is
reduced to [0, q) after every step.
"""

from __future__ import annotations

import numpy as np
import torch

from .aes import AES, key_expand
from .sampler import discrete_gaussian, gauss_thresholds, uniform_stream


def xof_layout(cfg: dict) -> dict:
    """Word offsets of one block's XOF row: the round constants' stream
    (their count plus the sampler's pad), then the noise draws' high and
    low words."""
    n, l, r = cfg["n"], cfg["l"], cfg["rounds"]
    n_rc = r * n + (n if cfg["kind"] == "hera" else l)
    n_noise = l if cfg["sigma"] > 0 else 0
    w_rc = n_rc + cfg["sampler_pad_words"]
    return {"n_rc": n_rc, "n_noise": n_noise, "w_rc": w_rc,
            "words": w_rc + 2 * n_noise}


class Keystream:
    """The keystream of one configuration under one key, on one device."""

    def __init__(self, cfg: dict, key, device):
        self.cfg = cfg
        self.q = int(cfg["q"])
        self.n, self.l = cfg["n"], cfg["l"]
        self.v = int(round(self.n ** 0.5))
        self.device = torch.device(device)
        self.layout = xof_layout(cfg)
        self.key = torch.as_tensor(np.asarray(key, np.int64), device=device)
        row = list(cfg["mix_first_row"])
        mix = torch.tensor([[row[(j - i) % self.v] for j in range(self.v)]
                            for i in range(self.v)], device=device)
        self.cols = [mix[:, j].view(1, self.v, 1) for j in range(self.v)]
        self.rows = [mix[:, j].view(1, 1, self.v) for j in range(self.v)]
        self.ic = torch.arange(1, self.n + 1, device=device) % self.q
        self.aes = AES(device)
        if self.layout["n_noise"]:
            self.tail, thr = gauss_thresholds(cfg["sigma"])
            self.thresholds = torch.as_tensor(thr, device=device)

    # --- the rounds ---------------------------------------------------
    def _mrmc(self, x):
        q, v = self.q, self.v
        X = x.reshape(-1, v, v)
        # (M X)[i, k] = sum_j M[i, j] X[j, k];  (Y M^T)[i, k] = sum_j Y[i, j] M[k, j]
        Y = sum(self.cols[j] * X[:, j:j + 1, :] for j in range(v)) % q
        Z = sum(Y[:, :, j:j + 1] * self.rows[j] for j in range(v)) % q
        return Z.reshape(x.shape)

    def _ark(self, x, rc):
        k = self.key[: x.shape[-1]]
        return (x + k * rc) % self.q

    def _nonlinear(self, x):
        q = self.q
        if self.cfg["kind"] == "hera":
            return x * x % q * x % q
        sq = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1] * x[:, :-1] % q],
                       dim=1)
        return (x + sq) % q

    def rounds(self, rc, noise=None):
        """(N, n_rc) round constants (+ (N, l) signed noise) -> (N, l)."""
        n, r = self.n, self.cfg["rounds"]
        x = self.ic.expand(rc.shape[0], n)
        x = self._ark(x, rc[:, :n])
        for i in range(1, r):
            x = self._ark(self._nonlinear(self._mrmc(x)), rc[:, i * n:(i + 1) * n])
        x = self._mrmc(self._nonlinear(self._mrmc(x)))[:, : self.l]
        x = self._ark(x, rc[:, r * n:])
        if noise is not None:
            x = (x + noise) % self.q
        return x

    # --- the constants --------------------------------------------------
    def tables(self, nonces):
        """(S, 16) uint8 nonces -> the per-session AES tables on device."""
        nonces = np.asarray(nonces, np.uint8).reshape(-1, 16)
        rk = torch.as_tensor(key_expand(nonces).astype(np.int32),
                             device=self.device)
        n12 = torch.as_tensor(nonces[:, :12].astype(np.int32),
                              device=self.device)
        return rk, n12

    def keystream(self, tables, sid, ctr, block: int = 1 << 15):
        """(N,) session indices into ``tables`` and block counters ->
        (N, l) int64 keystream words, computed ``block`` lanes at a time."""
        lay = self.layout
        out = []
        for a in range(0, sid.shape[0], block):
            s, c = sid[a:a + block], ctr[a:a + block]
            w = self.aes.xof_words(*tables, s, c, lay["words"])
            rc = uniform_stream(w[:, : lay["w_rc"]], lay["n_rc"], self.q)
            noise = None
            if lay["n_noise"]:
                k, b = lay["n_noise"], lay["w_rc"]
                noise = discrete_gaussian(w[:, b:b + k], w[:, b + k:b + 2 * k],
                                          self.tail, self.thresholds)
            out.append(self.rounds(rc, noise))
        return torch.cat(out) if out else torch.empty(
            (0, self.l), dtype=torch.int64, device=self.device)


# --- the fixed-point boundary ------------------------------------------
def encode(m, delta: float, q: int, dtype=torch.float32):
    """Messages -> Z_q words: round(m * delta) (half to even) in ``dtype``,
    negative values represented as q + value."""
    r = torch.round(m.to(dtype) * delta).to(torch.int64)
    return r % q


def decode(x, delta: float, q: int, dtype=torch.float32):
    """Z_q words -> messages: the centered value (x > q // 2 means x - q)
    in ``dtype``, over delta, as float32."""
    s = torch.where(x > q // 2, x - q, x)
    return (s.to(dtype).to(torch.float32) / delta).to(torch.float32)


def encrypt(m, z, delta: float, q: int, dtype=torch.float32):
    return (encode(m, delta, q, dtype) + z) % q


def decrypt(c, z, delta: float, q: int, dtype=torch.float32):
    return decode((c - z) % q, delta, q, dtype)
