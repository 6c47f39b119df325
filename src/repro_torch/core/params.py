"""Cipher parameter sets for HERA, Rubato, and PASTA.

Paper-benchmarked sets: HERA Par-128a (n=16, r=5, ~28-bit q, 96 round
constants) and Rubato Par-128L (n=64, r=2, ~25-bit q, 188 = 64+64+60 round
constants, truncation to l=60, AGN noise).  The PASTA family (Dobraunig et
al., the canonical third CKKS-targeting HHE stream cipher) rides the same
schedule IR: a two-branch state of 2t elements initialized from the key,
per-branch affine layers with additive per-block constants, branch mixing,
Feistel intermediate rounds and a cube final round, truncation to t — see
docs/DESIGN.md §11 for the stand-ins.  Moduli are Solinas primes of the
matching bit width (the papers do not list exact production moduli); the
mixing matrix for v != 4 is our documented circulant stand-in (docs/DESIGN.md §8).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.crypto.modmath import Modulus, Q_HERA, Q_PASTA, Q_RUBATO


@dataclasses.dataclass(frozen=True)
class CipherParams:
    name: str
    kind: str          # "hera" | "rubato" | "pasta"
    n: int             # state size (branches * a perfect square)
    l: int             # keystream length after truncation (hera: l == n)
    rounds: int        # r
    mod: Modulus
    sigma: float = 0.0  # AGN sigma (rubato only; 0 disables)
    xof: str = "aes"   # "aes" | "threefry"

    def __post_init__(self):
        if self.kind not in ("hera", "rubato", "pasta"):
            raise ValueError(f"unknown cipher kind {self.kind!r}")
        t = self.n // self.branches
        v = math.isqrt(t)
        if t * self.branches != self.n or v * v != t:
            raise ValueError(
                f"state size n={self.n} must be {self.branches} branch(es) "
                "of a perfect square"
            )
        if not (0 < self.l <= self.n):
            raise ValueError("invalid truncation length")
        if self.kind == "hera" and self.l != self.n:
            raise ValueError("HERA does not truncate")
        if self.kind == "pasta":
            if self.l != t:
                raise ValueError("PASTA truncates to one branch (l == n/2)")
            if self.sigma != 0.0:
                raise ValueError("PASTA has no AGN stage")
        # matvec accumulation bound (docs/DESIGN.md §2): v partial sums of < q
        if self.v * 3 * self.mod.q >= 2**33:
            raise ValueError("v*q too large for shift-add accumulation")

    @property
    def branches(self) -> int:
        """State branches: PASTA's two-word state; 1 for HERA/Rubato."""
        return 2 if self.kind == "pasta" else 1

    @property
    def v(self) -> int:
        """Per-branch matrix dimension: each branch is a (v, v) state."""
        return math.isqrt(self.n // self.branches)

    def schedule(self, variant: str = "normal"):
        """The declarative round program for this parameter set (cached).

        See `core/schedule.py` — the ONE place the round structure lives;
        executors (the plain interpreter, the CUDA keystream kernel's op
        table) all interpret it, and the accounting properties below
        derive from it.
        """
        from repro_torch.core.schedule import build_schedule

        return build_schedule(self, variant)

    @property
    def n_arks(self) -> int:
        """ARK executions per stream key (HERA/Rubato: initial + (r-1) RFs
        + final; PASTA: none — its key is the initial state and constants
        enter additively through the affine layers) — counted off the
        schedule program, not a duplicated formula."""
        return self.schedule().n_arks

    @property
    def n_round_constants(self) -> int:
        """Total uniform round constants per stream key, derived from the
        schedule's rc-slice annotations (the RNG FIFO depth).

        HERA: (r+1)*n (96 for Par-128a).  Rubato: r*n + l because the final
        ARK feeds a truncation, so only l of its constants matter (188 for
        Par-128L = 64+64+60), matching the paper's FIFO-depth accounting.
        """
        return self.schedule().n_round_constants

    @property
    def n_matrix_constants(self) -> int:
        """Matrix-plane words per stream key, derived from the schedule's
        mat-slice annotations (0 for HERA/Rubato; PASTA's stream-sourced
        affine layers draw (r+1)·n·t dense-matrix words)."""
        return self.schedule().n_matrix_constants

    @property
    def n_noise(self) -> int:
        return self.l if (self.kind == "rubato" and self.sigma > 0) else 0

    def mix_matrix(self) -> np.ndarray:
        """M_v: circulant with first row [2, 3, 1, ..., 1] (paper's M_4).

        For v=4 this is exactly the paper's matrix; v in {6, 8} uses the same
        circulant family (small coefficients {1,2,3} => shift-add datapath).
        """
        first = [2, 3] + [1] * (self.v - 2)
        rows = [np.roll(first, i) for i in range(self.v)]
        return np.array(rows, dtype=np.int64)

    def xof_words_per_block(self) -> int:
        """uint32 XOF words one stream-key block consumes (constants+noise).

        Uses the stream (compact) rejection sampler: ~1 word per constant +
        a fixed safety pad — this reproduces the paper's accounting of ~37
        AES invocations (~4700 bits) for Rubato Par-128L.
        """
        from repro_torch.crypto.sampler import words_needed_uniform_stream

        words = words_needed_uniform_stream(self.n_round_constants) + 2 * self.n_noise
        if self.n_matrix_constants:
            # Matrix planes draw AFTER rc+noise from the same per-block
            # stream, so the rc/noise word positions (and hence HERA/Rubato
            # streams) are unchanged by their presence.
            words += words_needed_uniform_stream(self.n_matrix_constants)
        return words


# HERA 80-bit set (the paper's other benchmarked HERA point): same state,
# one fewer round than Par-128a — the cheapest preset, which is why the
# serving-plane load bench leans on it.
HERA_80 = CipherParams(
    name="hera-80", kind="hera", n=16, l=16, rounds=4, mod=Q_HERA
)

HERA_128A = CipherParams(
    name="hera-128a", kind="hera", n=16, l=16, rounds=5, mod=Q_HERA
)

# Rubato family: bigger state <-> fewer rounds (Rubato paper's S/M/L split).
RUBATO_128S = CipherParams(
    name="rubato-128s", kind="rubato", n=16, l=12, rounds=5, mod=Q_RUBATO,
    sigma=1.6,
)
RUBATO_128M = CipherParams(
    name="rubato-128m", kind="rubato", n=36, l=32, rounds=3, mod=Q_RUBATO,
    sigma=1.6,
)
RUBATO_128L = CipherParams(
    name="rubato-128l", kind="rubato", n=64, l=60, rounds=2, mod=Q_RUBATO,
    sigma=1.6,
)

# PASTA family: two t-element branches (n = 2t, t = v^2 for the per-branch
# matrix datapath), keystream = one branch.  The S/L split mirrors the
# PASTA paper's Pasta-4 (smaller state, more rounds) / Pasta-3 (bigger
# state, fewer rounds) trade; t is a perfect square here so each branch
# rides the (v, v) shift-add matrix machinery (docs/DESIGN.md §11).
PASTA_128S = CipherParams(
    name="pasta-128s", kind="pasta", n=32, l=16, rounds=4, mod=Q_PASTA
)
PASTA_128L = CipherParams(
    name="pasta-128l", kind="pasta", n=128, l=64, rounds=3, mod=Q_PASTA
)

REGISTRY = {
    p.name: p for p in (HERA_80, HERA_128A, RUBATO_128S, RUBATO_128M,
                        RUBATO_128L, PASTA_128S, PASTA_128L)
}


def get_params(name: str) -> CipherParams:
    if name not in REGISTRY:
        raise KeyError(f"unknown cipher {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]
