"""Samplers over XOF words, in plain PyTorch: the stream rejection
sampler for uniform elements of Z_q and the discrete Gaussian.

The benchmark's own copy, frozen: it imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def uniform_stream(words, n_out: int, q: int):
    """Uniform Z_q elements from a row of XOF words by rejection.

    Each word's low bit_length(q) bits are a candidate, accepted when
    below q.  The accepted candidates, in stream order, give the first
    outputs; should a row accept fewer than ``n_out``, the rejected
    candidates follow in stream order, reduced mod q.
    words: (N, >= n_out) int64 word values -> (N, n_out) int64.
    """
    cand = words & ((1 << q.bit_length()) - 1)
    rejected = (cand >= q).to(torch.int8)
    order = torch.sort(rejected, dim=1, stable=True).indices[:, :n_out]
    picked = torch.gather(cand, 1, order)
    return picked % q


def gauss_thresholds(sigma: float) -> tuple[int, np.ndarray]:
    """(tail, thresholds): the centered discrete Gaussian on [-tail, tail],
    tail = ceil(10 sigma), as its 2*tail interior cumulative probabilities
    in 64-bit fixed point, computed in float64 and floored.  Returned as
    order-preserving int64 keys (the 64-bit value less 2^63)."""
    tail = int(math.ceil(10 * sigma))
    xs = np.arange(-tail, tail + 1, dtype=np.float64)
    w = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    cdf = np.cumsum(w / w.sum())[:-1]
    fixed = np.minimum(np.floor(cdf * 2.0 ** 64), float(2 ** 64 - 1))
    # the float64 cap is 2^64 itself, which 64 bits hold as 0
    keys = [int(f) % (1 << 64) - (1 << 63) for f in fixed]
    return tail, np.array(keys, np.int64)


def _key64(hi, lo):
    """(hi, lo) 32-bit word values -> order-preserving int64 key."""
    return (hi - (1 << 31)) * (1 << 32) + lo


def discrete_gaussian(hi, lo, tail: int, thresholds):
    """Inverse-CDF samples: the 64-bit draw (hi, lo) counts the thresholds
    it reaches.  hi, lo: (N, k) int64 word values; thresholds: (2*tail,)
    int64 keys on their device -> (N, k) int64 in [-tail, tail]."""
    u = _key64(hi, lo)
    return (u[..., None] >= thresholds).sum(-1) - tail
