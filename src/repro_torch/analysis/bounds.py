"""Abstract interpretation of schedule programs: overflow proofs + depth.

The port's copy of `repro.analysis.bounds`, on the port's own IR and
`repro_torch.crypto.modmath` bound enumerators.

The limb-scheme datapath (crypto/modmath.py) never forms a value that a
uint32 cannot hold — the invariant the reference's Pallas kernel trusts
and the port's int64 datapath mirrors value for value on every preset.
This module PROVES it statically, per (preset, variant), by walking the
schedule program and enumerating every worst-case intermediate bound the
datapath can reach:

  * the Modulus-level obligations (limb products, the shift-reduce
    constant, add/sub operands) come from
    :meth:`Modulus.mul_bound_sites` — enumerated from the same static
    constants ``mul``/``add`` trace with;
  * the per-op obligations (MRMC shift-add row accumulation with the
    preset's actual mix-matrix rows, Feistel/cube chains, affine constant
    adds, branch mixing, AGN signed folds) come from walking
    ``Schedule.op_table()`` and :meth:`Modulus.accumulate_sites`, which
    mirrors the EXACT interleaved-reduce policy `matvec_small` and the
    mrmc kernels' ``_combine`` execute;
  * every reduce site additionally proves the conditional-subtract chain
    fully reduces (worst-case residual <= q,
    :meth:`Modulus.reduce_residual_bound`) — a bound that fits uint32 but
    doesn't reduce is still a wrong answer.

Multiplicative depth is derived from the same walk (2 per Cube, 1 per
Feistel layer; linear ops free) and cross-checked against the
depth-tracked FV circuit's MEASURED depth (`core/transcipher.py`), so the
paper's HERA 10 / Rubato 2 / PASTA r+1 claims are pinned from two
independent directions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core import schedule as S
from repro_torch.core.params import CipherParams
from repro_torch.core.schedule import Schedule


@dataclasses.dataclass(frozen=True)
class SiteCheck:
    """One discharged (or violated) proof obligation at a datapath site."""

    provenance: str   # op_table provenance or "modulus q=..."
    site: str         # BoundSite.site
    bound: int        # worst-case value reached
    limit: int        # envelope (2^32 for u32 fit; q for residuals)
    ok: bool
    margin_bits: float

    def render(self) -> str:
        mark = "ok " if self.ok else "FAIL"
        return (f"  [{mark}] {self.provenance} :: {self.site}: "
                f"bound {self.bound} <= {self.limit} "
                f"(margin {self.margin_bits:+.2f} bits)")


@dataclasses.dataclass(frozen=True)
class OverflowProof:
    """The full obligation list for one (preset, variant) program."""

    schedule: str
    q: int
    checks: Tuple[SiteCheck, ...]

    @property
    def proved(self) -> bool:
        return all(c.ok for c in self.checks)

    @property
    def min_margin_bits(self) -> float:
        return min(c.margin_bits for c in self.checks)

    @property
    def tightest(self) -> SiteCheck:
        return min(self.checks, key=lambda c: c.margin_bits)

    def failures(self) -> Tuple[SiteCheck, ...]:
        return tuple(c for c in self.checks if not c.ok)


def _wrap(provenance: str, sites) -> list:
    return [SiteCheck(provenance=provenance, site=s.site, bound=s.bound,
                      limit=s.limit, ok=s.ok, margin_bits=s.margin_bits)
            for s in sites]


def _site(mod, provenance: str, name: str, bound: int) -> list:
    """A u32-fit obligation plus its reduce-completeness obligation."""
    from repro_torch.crypto.modmath import BoundSite

    return _wrap(provenance, (
        BoundSite(site=name, bound=bound, limit=2**32),
        BoundSite(site=name + " (residual)",
                  bound=mod.reduce_residual_bound(bound), limit=mod.q),
    ))


def _fit(provenance: str, name: str, bound: int) -> list:
    """A u32-fit-ONLY obligation: no reduce fires at this site (the value
    flows raw into a downstream accumulator that owns the reduce)."""
    from repro_torch.crypto.modmath import BoundSite

    return _wrap(provenance, (BoundSite(site=name, bound=bound,
                                        limit=2**32),))


def prove_overflow_safety(params: CipherParams,
                          schedule: Optional[Schedule] = None,
                          variant: str = "normal",
                          reduction: str = "eager",
                          plan=None) -> OverflowProof:
    """Prove every intermediate of ``schedule`` fits uint32 and reduces.

    The walk visits each op once; MRMC obligations use the preset's actual
    mix matrix rows (deduplicated — the circulant family repeats rows), so
    the proof covers exactly the accumulation schedule
    ``mrmc_matrix_apply`` unrolls.  Orientation never changes bounds (a
    flip is a relabeling), so one proof covers what both orientations of
    an op compute — but the variant is still walked op-for-op so
    provenance matches the program that ships.

    ``reduction`` selects which reduction schedule (`core/redplan.py`) the
    proof discharges: "eager" replays the legacy everything-reduced
    datapath; "lazy" replays every deferral the shipped plan makes — the
    relaxed ARK sum, the lazy shift-add accumulators at their raw term
    bounds, the deferred dense products at 3q in narrowed chunks, and the
    folded branch-mix terminal reduce — one obligation per deferred site.
    An explicit ``plan`` overrides the mode (the can-fail path: an
    over-deferred plan yields *undischarged* obligations here, including
    the terminal-reduction-law sites, rather than an exception).
    """
    if schedule is None:
        schedule = params.schedule(variant)
    mod = params.mod
    q = mod.q
    if plan is None:
        from repro_torch.core.redplan import plan_reductions

        plan = plan_reductions(params, schedule, reduction)
    from repro_torch.core import redplan as RP

    checks: list = []

    # Modulus-level obligations: limb products, shift-reduce, add/sub.
    checks += _wrap(f"modulus q={q} (L={mod.L}, R={mod.R})",
                    mod.mul_bound_sites())

    mat = params.mix_matrix()
    rows = {tuple(int(c) for c in row) for row in mat}

    for i, info in enumerate(schedule.op_table()):
        op = info.op
        prov = info.provenance
        p = plan.ops[i] if i < len(plan.ops) else RP.OpPlan(i, q, q)
        in_b = p.in_bound
        if isinstance(op, S.ARK):
            if p.has(RP.DEFER_OUT):
                # x (< in_b) + (k (.) rc) (< q) stays RAW: fit-only — the
                # next op's lazy accumulator owns the reduce
                checks += _fit(prov, "ark: x + k*rc (deferred, raw out)",
                               in_b + q)
            else:
                # x + (k (.) rc): mul output < q, x < in_b
                checks += _site(mod, prov, "ark: x + k*rc operands",
                                in_b + q)
        elif isinstance(op, S.MRMC):
            if op.streams_matrix:
                # stream-sourced dense affine layer: one t-term dense
                # matvec row per output element, accumulated under the
                # chunked policy matvec_dense / mrmc_dense_apply execute
                t = info.in_width // schedule.branches
                if p.has(RP.LAZY_DENSE):
                    # relaxed limb multiply (state operand < in_b) with the
                    # per-product final reduce deferred: raw products < 3q
                    checks += _wrap(
                        prov + " [lazy-dense mul]",
                        mod.mul_bound_sites(x_bound=q, y_bound=in_b,
                                            reduce_out=False))
                    checks += _wrap(prov, mod.dense_accumulate_sites(
                        t, site=f"dense matvec t={t} (lazy)",
                        prod_bound=3 * q))
                else:
                    checks += _wrap(prov, mod.dense_accumulate_sites(
                        t, site=f"dense matvec t={t}"))
            else:
                # two shift-add matvec passes (MixColumns then MixRows)
                # per branch run the same row set; bounds are per-row
                lazy_a = p.has(RP.LAZY_ACCUMULATE)
                for row in sorted(rows):
                    if lazy_a:
                        # first pass accepts operands < in_b; its rows are
                        # terminally reduced, so the second pass relaxes
                        # from q — both replayed at their true bounds
                        checks += _wrap(prov, mod.accumulate_sites(
                            row, site=f"mrmc row {list(row)} (lazy cols)",
                            in_bound=in_b, lazy=True))
                        checks += _wrap(prov, mod.accumulate_sites(
                            row, site=f"mrmc row {list(row)} (lazy rows)",
                            lazy=True))
                    else:
                        checks += _wrap(prov, mod.accumulate_sites(
                            row, site=f"mrmc row {list(row)}"))
            fold = p.has(RP.FOLD_MIX)
            mix_in = 2 * q if op.has_rc else q
            if op.has_rc:
                if fold:
                    checks += _fit(prov,
                                   "affine: matrix_out + rc (deferred, raw)",
                                   2 * q)
                else:
                    checks += _site(mod, prov, "affine: matrix_out + rc",
                                    2 * q)
            if op.mix_branches:
                if fold:
                    checks += _fit(prov, "branch mix: s = L + R (raw)",
                                   2 * mix_in)
                    checks += _site(mod, prov,
                                    "branch mix: s + L (and s + R), "
                                    "one terminal reduce", 3 * mix_in)
                else:
                    checks += _site(mod, prov, "branch mix: s = L + R",
                                    2 * q)
                    checks += _site(mod, prov,
                                    "branch mix: s + L (and s + R)", 2 * q)
        elif isinstance(op, S.NONLINEAR):
            if op.kind == "cube":
                # x^3 = mul(mul(x, x), x): both muls take [0, q) operands,
                # so the modulus-level mul obligations cover them; record
                # the chaining fact explicitly.
                checks += _site(mod, prov,
                                "cube: mul(mul(x,x),x) final sum", 3 * q)
            else:
                checks += _site(mod, prov, "feistel: x + shift(x^2)",
                                in_b + q)
        elif isinstance(op, S.AGN):
            # signed noise e with |e| < q folded to [0, 2q) then reduced,
            # then added to the state
            checks += _site(mod, prov, "agn: signed fold e + q", 2 * q)
            checks += _site(mod, prov, "agn: x + e_folded", in_b + q)
    # Terminal-reduction law (lint rule SA111): state must be fully
    # reduced before every TRUNCATE/AGN input and at program end.  Under
    # the shipped plans these discharge trivially; an over-deferred custom
    # plan surfaces here as an UNDISCHARGED obligation.
    from repro_torch.crypto.modmath import BoundSite

    for idx, what, bound in plan.terminal_sites(schedule):
        where = f"ops[{idx}]" if idx is not None else "program end"
        checks += _wrap(
            f"terminal-reduction law (SA111) [{plan.mode}]",
            (BoundSite(site=f"{where}: {what} fully reduced", bound=bound,
                       limit=q),))
    return OverflowProof(schedule=schedule.name, q=q, checks=tuple(checks))


# ==========================================================================
# Multiplicative depth
# ==========================================================================
#: paper depth laws per cipher kind, as a function of rounds r
PAPER_DEPTH = {
    "hera": lambda r: 2 * r,        # Cube = depth 2 per round (10 @ r=5)
    "rubato": lambda r: r,          # Feistel = depth 1 per round (2 @ r=2)
    "pasta": lambda r: r + 1,       # (r-1) Feistel + final Cube
}


def static_depth(schedule: Schedule) -> int:
    """Multiplicative depth derived by walking the program: ct x ct
    multiplies happen only in the nonlinear layers (ARK's k*rc is
    plaintext-by-ciphertext in the FV accounting; the linear layers are
    depth-free), and the state flows through every layer sequentially —
    so depth is simply the sum of per-layer depths."""
    depth = 0
    for op in schedule.ops:
        if isinstance(op, S.NONLINEAR):
            depth += 2 if op.kind == "cube" else 1
    return depth


@dataclasses.dataclass(frozen=True)
class DepthReport:
    """Static vs paper-law vs measured multiplicative depth."""

    schedule: str
    static: int
    paper: int
    measured: Optional[int]    # None = measurement skipped

    @property
    def ok(self) -> bool:
        if self.static != self.paper:
            return False
        return self.measured is None or self.measured == self.static

    def render(self) -> str:
        m = "-" if self.measured is None else str(self.measured)
        mark = "ok" if self.ok else "MISMATCH"
        return (f"depth {self.schedule}: static={self.static} "
                f"paper={self.paper} measured={m} [{mark}]")


def depth_report(params: CipherParams, variant: str = "normal",
                 measure: bool = True, device=None) -> DepthReport:
    """Derive the static depth and cross-check it both against the paper
    law for the cipher kind and (unless ``measure=False``) against the
    depth the FV circuit actually accumulates on one block (on
    ``device``, the card unless the caller asks for the CPU)."""
    sched = params.schedule(variant)
    static = static_depth(sched)
    paper = PAPER_DEPTH[params.kind](params.rounds)
    measured = None
    if measure:
        from repro_torch.core.transcipher import measured_depth

        measured = measured_depth(params, device=device)
    return DepthReport(schedule=sched.name, static=static, paper=paper,
                       measured=measured)
