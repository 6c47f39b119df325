"""Samplers driven by XOF words: uniform mod q (rejection) and the
discrete Gaussian (inverse CDF with a 64-bit fixed-point table).

The port's copy of `repro.crypto.sampler`, on int64 tensors holding the
uint32 word values.  :func:`uniform_mod_q_stream` is a *stable*
compaction of the accepted words, done here with a cumsum scatter (one
pass, no sort); :func:`discrete_gaussian` runs the reference's
lexicographic (hi, lo) compare on int64 lanes.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.crypto.modmath import Modulus
from repro_torch.device import upload

#: Candidates per constant of :func:`uniform_mod_q` (the reference's
#: fixed overdraw: P(all rejected) < 4e-15 per constant).
OVERDRAW = 4


def uniform_mod_q(words, mod: Modulus):
    """Map XOF words to uniform elements of Z_q by masked rejection.

    words: (..., n, OVERDRAW) int64 values in [0, 2^32), OVERDRAW
    candidates per output.  Returns (..., n) int64 in [0, q): the first
    accepted candidate, or the last candidate mod q when none is.
    """
    if words.shape[-1] != OVERDRAW:
        raise ValueError(f"expected trailing overdraw dim {OVERDRAW}")
    cand = words & ((1 << mod.bits) - 1)
    ok = cand < mod.q
    first = torch.argmax(ok.to(torch.int8), dim=-1, keepdim=True)
    picked = torch.gather(cand, -1, first)[..., 0]
    return torch.where(ok.any(-1), picked, cand[..., -1] % mod.q)


def words_needed_uniform(n: int) -> int:
    return n * OVERDRAW


# Safety pad for the stream sampler: P(more than STREAM_PAD rejections out
# of a few hundred draws at p < 2.5e-4) is < 1e-40.
STREAM_PAD = 16


def uniform_mod_q_stream(words, n_out: int, mod: Modulus):
    """XOF-economical rejection sampling over a flat word stream.

    words: (..., >= n_out + STREAM_PAD) int64 values in [0, 2^32).
    Accepted candidates (low ``bits`` bits < q) are compacted in stable
    order and the first ``n_out`` returned; should fewer than n_out be
    accepted, the rejected slots that follow fall back to candidate % q,
    exactly as the reference's stable argsort does.
    """
    if words.shape[-1] < n_out + STREAM_PAD:
        raise ValueError("need n_out + STREAM_PAD words")
    cand = words & ((1 << mod.bits) - 1)
    ok = cand < mod.q
    oki = ok.to(torch.int64)
    n_ok = oki.sum(-1, keepdim=True)
    # stable partition: accepted words keep their order at the front,
    # rejected ones keep theirs behind them
    pos = torch.where(ok, oki.cumsum(-1) - 1, n_ok + (1 - oki).cumsum(-1) - 1)
    sorted_cand = torch.empty_like(cand).scatter_(-1, pos, cand)[..., :n_out]
    sorted_ok = torch.empty_like(ok).scatter_(-1, pos, ok)[..., :n_out]
    return torch.where(sorted_ok, sorted_cand, sorted_cand % mod.q)


def words_needed_uniform_stream(n: int) -> int:
    return n + STREAM_PAD


@dataclasses.dataclass(frozen=True)
class DGaussTable:
    """Inverse-CDF table for a centered discrete Gaussian, sigma given.

    Thresholds are 64-bit fixed point stored as (hi, lo) uint32 pairs.
    Support is [-tail, +tail] with tail = ceil(10 sigma).  Built exactly as
    the reference builds it (numpy float64), so the tables are identical.
    """

    sigma: float
    tail: int
    hi: np.ndarray  # (2*tail,) uint32 — cumulative thresholds, ascending
    lo: np.ndarray

    @staticmethod
    def build(sigma: float) -> "DGaussTable":
        tail = int(math.ceil(10 * sigma))
        xs = np.arange(-tail, tail + 1)
        w = np.exp(-(xs.astype(np.float64) ** 2) / (2 * sigma**2))
        p = w / w.sum()
        cdf = np.cumsum(p)[:-1]  # 2*tail interior thresholds
        fixed = np.floor(cdf * float(2**64)).astype(np.float64)
        fixed = np.minimum(fixed, float(2**64 - 1))
        hi = (fixed / 2**32).astype(np.uint64).astype(np.uint32)
        lo = (fixed % 2**32).astype(np.uint64).astype(np.uint32)
        return DGaussTable(sigma=sigma, tail=tail, hi=hi, lo=lo)


def discrete_gaussian(words_hi, words_lo, table: DGaussTable):
    """Signed samples in [-tail, tail] (int64) by inverse CDF.

    words_hi/lo: int64 tensors of word values (the 64-bit uniform draw).
    """
    dev = words_hi.device
    hi_t = upload(table.hi.astype(np.int64), dev)
    lo_t = upload(table.lo.astype(np.int64), dev)
    u_hi = words_hi[..., None]
    u_lo = words_lo[..., None]
    ge = (u_hi > hi_t) | ((u_hi == hi_t) & (u_lo >= lo_t))
    idx = ge.to(torch.int64).sum(-1)  # in [0, 2*tail]
    return idx - table.tail



def words_needed_gauss(n: int) -> int:
    return 2 * n
