"""Modular arithmetic over Z_q for q < 2^28, on int64 tensors.

The port's copy of `repro.crypto.modmath`.  PyTorch's CPU uint32 has no
add, shift or compare, so plain paths hold Z_q values in int64 and every
op below runs the reference's exact datapath on them: the 2x2 limb
multiply with L = ceil(bits/2) <= 14, and the branchless
conditional-subtract reduce chain (`reduce_steps`).  Because every
intermediate the reference proves to fit uint32 is exact in int64, raw
(unreduced) outputs match the reference word for word, not only the
canonical residues.  The static bound enumerators are pure Python and
copied unchanged.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BoundSite:
    """One static proof obligation: a worst-case value ``bound`` at a named
    datapath site that must stay within ``limit`` (2^32 for uint32 fit;
    q for post-reduce residuals).  Enumerated by
    :meth:`Modulus.mul_bound_sites` / :meth:`Modulus.accumulate_sites` and
    consumed by `repro.analysis.bounds`."""

    site: str
    bound: int
    limit: int

    @property
    def ok(self) -> bool:
        return self.bound <= self.limit

    @property
    def margin_bits(self) -> float:
        """Headroom in bits (negative = violated)."""
        if self.bound <= 0:
            return float("inf")
        return math.log2(self.limit) - math.log2(self.bound)


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    # deterministic Miller-Rabin for n < 3.3e24 with these bases
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@dataclasses.dataclass(frozen=True)
class Modulus:
    """Static description of a prime modulus q < 2^28 plus limb constants."""

    q: int

    def __post_init__(self):
        if not (2 < self.q < 2**28):
            raise ValueError(f"q={self.q} out of supported range (2, 2^28)")
        if not _is_prime(self.q):
            raise ValueError(f"q={self.q} must be prime")
        # Safety envelope for the limb scheme (checked, not assumed).
        if self.R * (1 << self.L) + (1 << (2 * self.L)) >= 2**32:
            raise ValueError(
                f"q={self.q}: R=2^(2L) mod q = {self.R} too large for the "
                "uint32 limb scheme; pick a Solinas-form prime"
            )

    # ---- static (Python int) derived constants -------------------------
    @property
    def bits(self) -> int:
        return self.q.bit_length()

    @property
    def L(self) -> int:
        """Limb width in bits."""
        return (self.bits + 1) // 2

    @property
    def mask(self) -> int:
        return (1 << self.L) - 1

    @property
    def R(self) -> int:
        """2^(2L) mod q — the shift-reduce constant."""
        return (1 << (2 * self.L)) % self.q

    # ---- reduction helpers ---------------------------------------------
    def reduce_steps(self, bound: int) -> tuple:
        """The static multiples m of q the conditional-subtract chain in
        :meth:`reduce` fires for operands < ``bound``, largest first.

        This IS the chain `reduce` executes (it consults this helper), so
        the static-analysis proof over these steps
        (`repro.analysis.bounds`) describes the shipped datapath, not a
        model of it.
        """
        q = self.q
        k = (bound + q - 1) // q  # x < k*q
        m = 1
        while m * 2 < k:
            m *= 2
        steps = []
        # subtract m*q, m/2*q, ..., q
        while m >= 1:
            steps.append(m)
            m //= 2
        return tuple(steps)

    def reduce_residual_bound(self, bound: int) -> int:
        """Exact worst-case value bound after :meth:`reduce` on operands
        < ``bound`` — an interval walk of the conditional-subtract chain.

        Full reduction means the result is <= q, i.e. values land in
        [0, q); `repro.analysis.bounds` asserts that (and that ``bound``
        itself fits uint32) for every static reduce site in the cipher
        datapath.
        """
        b = bound
        for m in self.reduce_steps(bound):
            mq = m * self.q
            if b > mq:
                # values >= mq drop to < b - mq; values < mq are untouched
                b = max(mq, b - mq)
        return b

    def reduce(self, x, bound: int):
        """Reduce x (values < bound) into [0, q) with conditional subtracts.

        ``bound`` is a static Python int.  Uses ceil(log2(bound/q)) steps,
        each subtracting the largest power-of-two multiple of q that can
        still be present (the step schedule is :meth:`reduce_steps`).
        """
        for m in self.reduce_steps(bound):
            mq = m * self.q
            x = torch.where(x >= mq, x - mq, x)
        return x

    # ---- arithmetic ------------------------------------------------------
    def add(self, x, y):
        return self.reduce(x + y, 2 * self.q)

    def sub(self, x, y):
        return self.reduce(x + self.q - y, 2 * self.q)

    def neg(self, x):
        return self.reduce(self.q - x, 2 * self.q)

    def _shiftL(self, v):
        """v * 2^L mod q for v in [0, q)."""
        a = v >> self.L          # < 2^(bits - L) <= 2^L
        b = v & self.mask
        # a * R < 2^L * R ; b << L < 2^(2L); sum < 2^32 by __post_init__ check
        t = a * self.R + (b << self.L)
        bound = (1 << self.L) * self.R + (1 << (2 * self.L))
        return self.reduce(t, bound)

    def _limb_high_bound(self, bound: int) -> int:
        """Exclusive bound on the high limb of values < ``bound``."""
        return ((bound - 1) >> self.L) + 1

    def _mul_limb_bounds(self, x_bound: int, y_bound: int) -> tuple:
        """Static (p0, p1, p2) partial-product bounds for `mul` operands
        < ``x_bound`` / < ``y_bound``.  Reduced operands (both <= q) get
        the legacy constants, so default call graphs are unchanged."""
        two_l = 1 << (2 * self.L)
        if x_bound <= self.q and y_bound <= self.q:
            return two_l, 2 * two_l, two_l
        xh = self._limb_high_bound(x_bound)
        yh = self._limb_high_bound(y_bound)
        return two_l, (1 << self.L) * (xh + yh), xh * yh

    def mul_fits(self, x_bound: int | None = None,
                 y_bound: int | None = None) -> bool:
        """True iff :meth:`mul` on operands < ``x_bound`` / < ``y_bound``
        keeps every partial product inside uint32 — the feasibility test
        the reduction-scheduling pass (`core/redplan.py`) consults before
        relaxing an input bound."""
        xb = self.q if x_bound is None else x_bound
        yb = self.q if y_bound is None else y_bound
        if max(xb, yb) > 2**32:
            return False
        _, p1, p2 = self._mul_limb_bounds(xb, yb)
        return p1 < 2**32 and p2 < 2**32

    def mul_reduce_steps(self, x_bound: int | None = None,
                         y_bound: int | None = None,
                         reduce_out: bool = True) -> int:
        """Conditional-subtract steps ONE :meth:`mul` call fires under the
        given bounds — replayed from the same step schedules the datapath
        executes (`repro.analysis.cost` uses this for the eager-vs-lazy
        reduction delta)."""
        xb = self.q if x_bound is None else x_bound
        yb = self.q if y_bound is None else y_bound
        p0b, p1b, p2b = self._mul_limb_bounds(xb, yb)
        shift_b = (1 << self.L) * self.R + (1 << (2 * self.L))
        steps = sum(len(self.reduce_steps(b)) for b in (p0b, p1b, p2b))
        steps += 3 * len(self.reduce_steps(shift_b))   # shiftL(p1), 2x shiftL(p2)
        if reduce_out:
            steps += len(self.reduce_steps(3 * self.q))
        return steps

    def mul(self, x, y, *, x_bound: int | None = None,
            y_bound: int | None = None, reduce_out: bool = True):
        """x*y mod q via 2x2 limb decomposition.

        Default: inputs in [0, q), fully reduced output — the legacy
        datapath, graph-identical to before the reduction-scheduling pass
        existed.  ``x_bound``/``y_bound`` relax the input contract (the
        limb recombination recomputes its partial-product bounds; caller
        must have checked :meth:`mul_fits`); ``reduce_out=False`` defers
        the final reduce, returning a raw value < 3q.
        """
        xb = self.q if x_bound is None else x_bound
        yb = self.q if y_bound is None else y_bound
        if not self.mul_fits(xb, yb):
            raise ValueError(
                f"mul operand bounds ({xb}, {yb}) overflow the uint32 limb "
                "scheme; reduce an input first (see Modulus.mul_fits)"
            )
        p0b, p1b, p2b = self._mul_limb_bounds(xb, yb)
        m = self.mask
        xl, xh = x & m, x >> self.L
        yl, yh = y & m, y >> self.L
        p0 = self.reduce(xl * yl, p0b)
        p1 = self.reduce(xl * yh + xh * yl, p1b)
        p2 = self.reduce(xh * yh, p2b)
        t1 = self._shiftL(p1)                    # p1 * 2^L
        t2 = self._shiftL(self._shiftL(p2))      # p2 * 2^(2L)
        s = p0 + t1 + t2                         # < 3q
        return self.reduce(s, 3 * self.q) if reduce_out else s

    def square(self, x):
        return self.mul(x, x)

    def cube(self, x):
        return self.mul(self.mul(x, x), x)

    def mul_small(self, x, c: int, *, in_bound: int | None = None,
                  reduce_out: bool = True):
        """x * c mod q for a small static constant c (shift-add datapath).

        This is the paper's T4: the MixColumns/MixRows matrix has entries in
        {1, 2, 3}, so products are realized as adds, never multiplies.
        Requires c * in_bound < 2^32 (``in_bound`` defaults to q — reduced
        input).  ``reduce_out=False`` returns the raw add chain (< c·in_bound)
        for a lazy accumulator to fold into ONE terminal reduce.
        """
        b = self.q if in_bound is None else in_bound
        if c * b >= 2**32:
            raise ValueError("constant too large for shift-add path")
        if c == 0:
            return torch.zeros_like(x)
        if c == 1 and (b <= self.q or not reduce_out):
            return x
        acc = x
        for _ in range(c - 1):
            acc = acc + x
        return self.reduce(acc, c * b) if reduce_out else acc

    def matvec_small(self, mat: np.ndarray, x, axis: int = -1, *,
                     in_bound: int | None = None, lazy: bool = False):
        """y = mat @ x mod q along ``axis`` where mat has small int entries.

        mat: (v, v) numpy int array with entries in {0..3}.  x: uint32 array
        whose ``axis`` dim has size v.  Implemented as shift-add accumulation
        with partial-sum bounds checked statically: accumulator stays < 2^32
        because v * 3 * q is verified at trace time (reduce interleaved when
        it would not be).

        ``lazy=True`` is the reduction-scheduling pass's lazy-accumulate
        policy (`core/redplan.py`): terms stay *raw* (no per-term reduce),
        operands may be unreduced up to ``in_bound`` (default q), and each
        row fires ONE terminal reduce — proven safe per row by
        :meth:`accumulate_sites`.  Output is fully reduced either way.
        """
        v = mat.shape[0]
        in_b = self.q if in_bound is None else in_bound
        if not lazy and in_b > self.q:
            raise ValueError(
                "matvec_small eager path needs reduced operands; pass "
                "lazy=True to accept relaxed input bounds")
        x = torch.movedim(x, axis, -1)
        outs = []
        for i in range(v):
            acc = None
            bound = 0
            for j in range(v):
                c = int(mat[i, j])
                if c == 0:
                    continue
                if lazy:
                    term = self.mul_small(x[..., j], c, in_bound=in_b,
                                          reduce_out=False)
                    tb = c * in_b
                else:
                    term = self.mul_small(x[..., j], c)  # < q
                    tb = self.q
                if acc is None:
                    acc, bound = term, tb
                else:
                    if bound + tb >= 2**32:
                        acc = self.reduce(acc, bound)
                        bound = self.q
                    acc = acc + term
                    bound += tb
            outs.append(self.reduce(acc, bound))
        y = torch.stack(outs, dim=-1)
        return torch.movedim(y, -1, axis)

    def dense_chunk(self, prod_bound: int | None = None) -> int:
        """How many products < ``prod_bound`` (default q) the dense-matvec
        accumulator can sum in uint32 before it must reduce — the ONE
        policy constant shared by :meth:`matvec_dense` and the overflow
        proof (:meth:`dense_accumulate_sites`).  For the shipped
        PASTA modulus (q = 2^26 - 2^12 + 1) this is 64, so a whole t=64
        branch row sums in one pass; under the lazy plan's deferred
        products (< 3q) it shrinks to 21.
        """
        return (2**32 - 1) // (self.q if prod_bound is None else prod_bound)

    def dense_chunk_schedule(self, t: int,
                             prod_bound: int | None = None) -> tuple:
        """(chunk, n_chunks) for a t-term dense row of products <
        ``prod_bound``: chunk is the LARGEST DIVISOR of t that still sums
        raw in uint32 (:meth:`dense_chunk`), so the accumulator splits by
        a reshape — one fused sum per level — instead of ragged
        sequential slices that defeat XLA fusion.  The n_chunks reduced
        partials (< q each) then fold in one raw sum < n_chunks·q.  For
        the shipped PASTA modulus: eager t=64 → (64, 1) (whole row, one
        pass, graph-identical to the pre-pass datapath); lazy deferred
        products < 3q shrink the cap to 21, so t=64 → (16, 4) and
        t=16 → (16, 1).
        """
        cap = max(1, self.dense_chunk(prod_bound))
        ch = max(d for d in range(1, min(cap, t) + 1) if t % d == 0)
        nch = t // ch
        if nch * self.q >= 2**32:
            raise ValueError(
                f"dense chunk schedule ({ch}, {nch}) for t={t}: "
                f"{nch} reduced partials overflow the uint32 fold")
        return ch, nch

    def matvec_dense(self, mat, x, *, x_bound: int | None = None,
                     lazy: bool = False):
        """y = mat @ x mod q for a *dense* uint32 matrix with entries in
        [0, q) — PASTA's stream-sourced affine layer (no shift-add
        structure to exploit, unlike :meth:`matvec_small`).

        mat: (..., t, t) uint32; x: (..., t) uint32; returns (..., t).
        Every product from :meth:`mul` is < q, so chunks of
        :meth:`dense_chunk_schedule` products are summed in raw uint32
        (a reshape, one fused sum), reduced once per chunk, and the
        reduced partials fold in one final raw sum + reduce.

        ``lazy=True`` (the reduction-scheduling pass's lazy-dense policy)
        defers each product's final reduce — t² fewer 3q-reduces per
        matrix — accumulating raw values < 3q in proportionally narrower
        chunks; ``x_bound`` additionally relaxes the operand contract
        through the limb multiply.  Output is fully reduced either way.
        """
        t = x.shape[-1]
        if lazy:
            prods = self.mul(mat, x[..., None, :], y_bound=x_bound,
                             reduce_out=False)   # (..., t, t), each < 3q
            pb = 3 * self.q
        else:
            if x_bound is not None and x_bound > self.q:
                raise ValueError(
                    "matvec_dense eager path needs reduced operands; pass "
                    "lazy=True to accept relaxed input bounds")
            prods = self.mul(mat, x[..., None, :])   # (..., t, t), each < q
            pb = self.q
        ch, nch = self.dense_chunk_schedule(t, pb)
        s = prods.reshape(prods.shape[:-1] + (nch, ch)).sum(-1)  # (..., t, nch)
        s = self.reduce(s, ch * pb)                  # each < q
        if nch == 1:
            return s[..., 0]
        return self.reduce(s.sum(-1), nch * self.q)

    # ---- static bound enumeration (repro.analysis substrate) -----------
    def dense_accumulate_sites(self, t: int, site: str = "dense-matvec",
                               prod_bound: int | None = None) -> tuple:
        """Proof obligations for one dense t-term matvec row — replays the
        EXACT chunked accumulation of :meth:`matvec_dense` /
        ``mrmc_dense_apply``: ``n_chunks`` identical uint32 sums of
        ``chunk`` products < ``prod_bound`` (q eager; 3q under the lazy
        plan's deferred products), one reduce per chunk, then one raw
        fold of the reduced partials (:meth:`dense_chunk_schedule`).
        """
        pb = self.q if prod_bound is None else prod_bound
        ch, nch = self.dense_chunk_schedule(t, pb)
        b = ch * pb
        sites = [
            BoundSite(site=f"{site}:chunk sum of {ch} products (x{nch})",
                      bound=b, limit=2**32),
            BoundSite(site=f"{site}:chunk residual",
                      bound=self.reduce_residual_bound(b),
                      limit=self.q),
        ]
        if nch > 1:
            fb = nch * self.q
            sites.append(BoundSite(
                site=f"{site}:partial-sum fold of {nch} chunks",
                bound=fb, limit=2**32))
            sites.append(BoundSite(
                site=f"{site}:fold residual",
                bound=self.reduce_residual_bound(fb),
                limit=self.q))
        return tuple(sites)

    def mul_bound_sites(self, x_bound: int | None = None,
                        y_bound: int | None = None,
                        reduce_out: bool = True) -> tuple:
        """Every static intermediate bound `mul` (and thus square/cube)
        reaches, as :class:`BoundSite` records — the uint32-overflow proof
        obligations of the limb scheme, enumerated from the same constants
        the datapath uses.  Relaxed ``x_bound``/``y_bound`` and
        ``reduce_out=False`` replay the partial-product bounds a
        plan-relaxed :meth:`mul` actually runs with.

        For each reduce call two obligations are emitted: the operand
        bound must fit uint32, and the conditional-subtract chain must
        fully reduce it (worst-case residual <= q,
        :meth:`reduce_residual_bound`).  A deferred output emits a
        fit-only obligation (no reduce fires there — downstream owns it).
        """
        xb = self.q if x_bound is None else x_bound
        yb = self.q if y_bound is None else y_bound
        p0b, p1b, p2b = self._mul_limb_bounds(xb, yb)
        two_l = 1 << (2 * self.L)
        shift_t = (1 << self.L) * self.R + two_l
        entries = [
            ("mul:p0 = xl*yl", p0b),
            ("mul:p1 = xl*yh + xh*yl", p1b),
            ("mul:p2 = xh*yh", p2b),
            ("mul:shiftL t = a*R + (b<<L)", shift_t),
        ]
        if reduce_out:
            entries.append(("mul:p0 + p1*2^L + p2*2^2L", 3 * self.q))
        entries += [
            ("add:x + y", 2 * self.q),
            ("sub:x + q - y", 2 * self.q),
        ]
        sites = []
        for name, bound in entries:
            sites.append(BoundSite(site=name, bound=bound, limit=2**32))
            sites.append(BoundSite(site=name + " (residual)",
                                   bound=self.reduce_residual_bound(bound),
                                   limit=self.q))
        if not reduce_out:
            sites.append(BoundSite(
                site="mul:p0 + p1*2^L + p2*2^2L (deferred, unreduced out)",
                bound=3 * self.q, limit=2**32))
        return tuple(sites)

    def accumulate_sites(self, coeffs, site: str = "matvec",
                         in_bound: int | None = None,
                         lazy: bool = False) -> tuple:
        """Worst-case accumulator bound walk for one shift-add row sum.

        ``coeffs`` is one row of a small-constant mix matrix.  Mirrors the
        EXACT interleaved-reduce policy shared by :meth:`matvec_small` and
        the mrmc kernels' ``_combine``: each term is ``mul_small``-scaled
        (an add chain bounded by c*q, then reduced), and the running sum
        reduces to < q whenever the next add could reach 2^32.  With
        ``lazy=True`` (and operands < ``in_bound``, default q) the terms
        stay raw at c·in_bound each, matching the lazy-accumulate policy.
        Returns one :class:`BoundSite` per scaled term, one for the
        accumulator peak, and one for the final residual.
        """
        in_b = self.q if in_bound is None else in_bound
        sites = []
        bound = 0
        peak = 0
        for j, c in enumerate(coeffs):
            c = int(c)
            if c == 0:
                continue
            tb = c * in_b if lazy else self.q
            if lazy:
                if c > 1 or in_b > self.q:
                    sites.append(BoundSite(site=f"{site}:term[{j}] {c}*x "
                                                f"raw chain", bound=tb,
                                           limit=2**32))
            elif c > 1:
                sites.append(BoundSite(site=f"{site}:term[{j}] {c}*x add "
                                            f"chain", bound=c * self.q,
                                       limit=2**32))
            if bound == 0:
                bound = tb
            else:
                if bound + tb >= 2**32:
                    bound = self.q    # interleaved reduce fires
                bound += tb
            peak = max(peak, bound)
        sites.append(BoundSite(site=f"{site}:accumulator peak",
                               bound=peak, limit=2**32))
        sites.append(BoundSite(site=f"{site}:row residual",
                               bound=self.reduce_residual_bound(peak),
                               limit=self.q))
        return tuple(sites)

    def from_signed(self, e):
        """Map signed values (|e| < q) into [0, q), as int64."""
        e = e.to(torch.int64)
        return torch.where(e < 0, e + self.q, e)

    def to_signed(self, x):
        """Centered representative in (-q/2, q/2]."""
        x = x.to(torch.int64)
        return torch.where(x > self.q // 2, x - self.q, x)


# Shipped Solinas primes (verified prime in __post_init__).
Q_HERA = Modulus(2**28 - 2**16 + 1)    # 268369921, 28-bit (HERA Par-128a scale)
Q_RUBATO = Modulus(2**25 - 2**14 + 1)  # 33538049, 25-bit (Rubato Par-128L scale)
Q_PASTA = Modulus(2**26 - 2**12 + 1)   # 67104769, 26-bit (PASTA plaintext scale)
