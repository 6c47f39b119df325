"""Schedule-program linter: registered safety rules beyond `validate()`.

The port's copy of `repro.analysis.lint`, run on the port's own IR
(`repro_torch.core.schedule`, `repro_torch.core.redplan`).

``Schedule.validate()`` is the executor gate — it raises on the first
inconsistency so a malformed program can never run.  The linter is the
*diagnostic* gate: it walks the whole program (via ``Schedule.op_table()``,
which never raises), reports EVERY violation with an error code, severity,
op index, and provenance, and supports noqa-style suppression — so a new
``build_schedule`` variant gets a complete diagnosis instead of the first
``ValueError``, and CI can gate on "no lint errors" across the full
preset x variant matrix.

Rule catalog (docs/DESIGN.md §13 — keep in sync):

  SA101  rc-coverage       round-constant slices must tile [0, max) exactly
  SA102  rc-shape          rc-slice width vs state width / ARK key_len laws
  SA103  orientation-chain each op's declared orientation == chain state
  SA104  orientation-parity flips must net out: program ends NORMAL
  SA105  truncate-last     at most one TRUNCATE; only ARK/AGN may follow
  SA106  agn-placement     AGN only on rubato programs, once, as last op
  SA107  branch-shape      PASTA laws: branches/mix/init/ARK consistency
  SA108  rc-storage-perm   FIFO reorder is a slice-local, branch-local perm
  SA109  op-fields         enum fields (orientation, nonlinearity) in range
  SA110  mat-plane-shape   stream ops carry a well-formed matrix-plane slice
  SA111  terminal-reduction state fully reduced at TRUNCATE/AGN/program end
                           under the active reduction plan (core/redplan.py)
  SA201  vacuous-variant   (warning) alternating plan that never flips

Suppression: a rule code listed in ``Schedule.suppress`` (the program's
own ``# noqa`` escape hatch) or passed via ``lint(sched, suppress=...)``
is skipped.  Errors gate CI; warnings are reported but never fail.

Plan-aware rules: checkers declaring a third parameter receive the
``ReductionPlan`` passed to ``lint(sched, plan=...)`` (None when the
caller lints the schedule alone) — the linter threads reduction-schedule
context without changing the two-argument rule contract.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core import schedule as S
from repro_torch.core.schedule import Schedule

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to the op that caused it."""

    code: str
    severity: str            # "error" | "warning"
    rule: str                # short rule name ("rc-coverage")
    message: str
    schedule: str            # schedule name ("pasta-128l/alternating")
    op_index: Optional[int]  # None = whole-program finding
    provenance: str          # op_table provenance, or the schedule name

    def render(self) -> str:
        sev = self.severity.upper()
        return f"{self.code} [{sev}] {self.provenance}: {self.message}"


@dataclasses.dataclass(frozen=True)
class Rule:
    code: str
    name: str
    severity: str
    doc: str
    check: Callable[[Schedule, Tuple[S.OpInfo, ...]],
                    Iterator[Tuple[Optional[int], str]]]


_RULES: Dict[str, Rule] = {}


def rule(code: str, name: str, severity: str = ERROR):
    """Register a checker.  Checkers take (schedule, op_table) and yield
    (op_index | None, message) pairs; the framework wraps them into
    :class:`Finding`s with provenance."""

    def deco(fn):
        if code in _RULES:
            raise ValueError(f"lint rule {code} already registered")
        _RULES[code] = Rule(code=code, name=name, severity=severity,
                            doc=(fn.__doc__ or "").strip(), check=fn)
        return fn

    return deco


def registered_rules() -> Tuple[Rule, ...]:
    """All rules, sorted by code — the catalog docs/DESIGN.md §13 mirrors."""
    return tuple(_RULES[c] for c in sorted(_RULES))


def lint(sched: Schedule, suppress: Iterable[str] = (),
         plan=None) -> List[Finding]:
    """Run every registered rule over ``sched``; return all findings.

    Rules named in ``suppress`` or in ``sched.suppress`` are skipped
    entirely (the noqa mechanism).  Unknown codes in either set raise —
    a suppression that matches nothing is a stale escape hatch.

    ``plan`` (a `core.redplan.ReductionPlan`, optional) is handed to
    plan-aware rules — checkers whose signature declares a third
    parameter (SA111) — so reduction-schedule laws lint alongside the
    structural ones; with ``plan=None`` those rules have nothing to check.
    """
    muted = set(suppress) | set(sched.suppress)
    unknown = muted - set(_RULES)
    if unknown:
        raise ValueError(
            f"unknown lint rule code(s) suppressed: {sorted(unknown)}; "
            f"registered: {sorted(_RULES)}"
        )
    table = sched.op_table()
    findings: List[Finding] = []
    for r in registered_rules():
        if r.code in muted:
            continue
        takes_plan = len(inspect.signature(r.check).parameters) >= 3
        results = r.check(sched, table, plan) if takes_plan \
            else r.check(sched, table)
        for op_index, message in results:
            prov = (table[op_index].provenance
                    if op_index is not None and op_index < len(table)
                    else sched.name)
            findings.append(Finding(
                code=r.code, severity=r.severity, rule=r.name,
                message=message, schedule=sched.name, op_index=op_index,
                provenance=prov,
            ))
    return findings


def errors(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == ERROR]


# ==========================================================================
# Helpers
# ==========================================================================
def _rc_ops(table):
    """(OpInfo, rc_slice) for every constant-consuming op, program order."""
    out = []
    for info in table:
        op = info.op
        if isinstance(op, S.ARK):
            out.append((info, op.rc_slice))
        elif isinstance(op, S.MRMC) and op.has_rc:
            out.append((info, op.rc_slice))
    return out


# ==========================================================================
# Rules
# ==========================================================================
@rule("SA101", "rc-coverage")
def _check_rc_coverage(sched, table):
    """Round-constant slices must tile [0, max_end) exactly — no gap, no
    overlap, no reuse: the producer's FIFO delivers each constant once and
    the accounting (n_round_constants) is the max slice end."""
    rc = _rc_ops(table)
    if not rc:
        yield None, ("program consumes no round constants at all (every "
                     "cipher draws per-block randomness)")
        return
    covered = np.zeros(max(0, max(b for _, (_, b) in rc)), dtype=np.int32)
    for info, (a, b) in rc:
        if a < 0 or b <= a:
            yield info.index, f"degenerate rc_slice [{a}, {b})"
            continue
        covered[a:b] += 1
    gaps = np.flatnonzero(covered == 0)
    if gaps.size:
        yield None, (f"rc stream has {gaps.size} unconsumed constant(s), "
                     f"first at index {int(gaps[0])} (gap in slice tiling)")
    over = np.flatnonzero(covered > 1)
    if over.size:
        yield None, (f"{over.size} constant(s) consumed more than once, "
                     f"first at index {int(over[0])} (overlapping slices)")
    prev_end = 0
    for info, (a, b) in rc:
        if a != prev_end:
            yield info.index, (
                f"rc_slice starts at {a} but the FIFO cursor is at "
                f"{prev_end} — constants must be consumed in stream order")
        prev_end = max(prev_end, b)


@rule("SA102", "rc-shape")
def _check_rc_shape(sched, table):
    """Constant-slice widths must match the state: an ARK consumes exactly
    key_len == state-width constants (Rubato's final truncated ARK included),
    and an affine MRMC adds exactly state-width constants."""
    for info in table:
        op = info.op
        if isinstance(op, S.ARK):
            a, b = op.rc_slice
            if b - a != op.key_len:
                yield info.index, (f"rc_slice width {b - a} != key_len "
                                   f"{op.key_len}")
            if op.key_len != info.in_width:
                yield info.index, (f"key_len {op.key_len} != state width "
                                   f"{info.in_width} at this op")
        elif isinstance(op, S.MRMC) and op.has_rc:
            a, b = op.rc_slice
            if b - a != info.in_width:
                yield info.index, (f"affine rc_slice width {b - a} != "
                                   f"state width {info.in_width}")


@rule("SA103", "orientation-chain")
def _check_orientation_chain(sched, table):
    """Every op must declare the orientation the chain actually delivers:
    only MRMC may change orientation (out_orientation), so a mismatch means
    the op would read a differently-laid-out state than it was compiled
    for — silent wrong answers in the storage-order kernels."""
    for info in table:
        if info.op.orientation != info.chain_orientation:
            yield info.index, (
                f"declares {info.op.orientation} input but the chain is "
                f"{info.chain_orientation} here (flips happen only at MRMC "
                f"out_orientation)")


@rule("SA104", "orientation-parity")
def _check_orientation_parity(sched, table):
    """Orientation flips must net out: the program must END in normal
    orientation (keystream bytes are defined row-major).  An alternating
    variant with an odd uncompensated flip count emits transposed output."""
    if table and table[-1].out_orientation != S.NORMAL:
        flips = sum(1 for i in table
                    if isinstance(i.op, S.MRMC)
                    and i.op.orientation != i.op.out_orientation)
        yield None, (f"program ends in transposed orientation "
                     f"({flips} net-odd MRMC flip(s)); output relabeling "
                     f"does not net to normal")


@rule("SA105", "truncate-last")
def _check_truncate_last(sched, table):
    """TRUNCATE is a terminal narrowing: at most one, in normal
    orientation, keep == schedule.l, and only width-l ops (ARK, AGN) may
    follow — a matrix or Feistel layer after truncation would read past
    the narrowed state."""
    seen = None
    for info in table:
        op = info.op
        if isinstance(op, S.TRUNCATE):
            if seen is not None:
                yield info.index, "second TRUNCATE (only one allowed)"
            seen = info.index
            if info.chain_orientation != S.NORMAL:
                yield info.index, "TRUNCATE needs normal orientation"
            if not (0 < op.keep <= info.in_width):
                yield info.index, (f"keep {op.keep} out of range for state "
                                   f"width {info.in_width}")
            if op.keep != sched.l:
                yield info.index, (f"keep {op.keep} != schedule.l "
                                   f"{sched.l}")
        elif seen is not None and not isinstance(op, (S.ARK, S.AGN)):
            yield info.index, (f"{type(op).__name__} after TRUNCATE "
                               f"(ops[{seen}]); only ARK/AGN may follow")
    if seen is None and sched.l < sched.n:
        yield None, (f"l={sched.l} < n={sched.n} but the program never "
                     f"truncates")


@rule("SA106", "agn-placement")
def _check_agn_placement(sched, table):
    """AGN is Rubato's client-side noise stage: legal only on rubato
    programs, at most once, as the final op, in normal orientation — noise
    added mid-program would be amplified by later rounds and break the
    cipher's (and the HE noise budget's) accounting."""
    agns = [i for i in table if isinstance(i.op, S.AGN)]
    for info in agns[1:]:
        yield info.index, "second AGN (only one allowed)"
    if agns:
        info = agns[0]
        if sched.kind != "rubato":
            yield info.index, (f"AGN on a {sched.kind!r} program (only "
                               f"rubato carries cipher-side noise)")
        if info.index != len(table) - 1:
            yield info.index, "AGN must be the final op"
        if info.chain_orientation != S.NORMAL:
            yield info.index, "AGN needs normal orientation"


@rule("SA107", "branch-shape")
def _check_branch_shape(sched, table):
    """PASTA branch laws: branch count matches the state factorization
    (n == branches * v^2), branch mixing only exists on 2-branch states
    and then on EVERY affine layer, and keyed-init programs carry no ARK
    (the key already is the state; an ARK would re-key mid-permutation)."""
    if sched.n != sched.branches * sched.v * sched.v:
        yield None, (f"n={sched.n} != branches*v^2 = "
                     f"{sched.branches * sched.v * sched.v}")
    for info in table:
        op = info.op
        if isinstance(op, S.MRMC) and op.mix_branches and sched.branches != 2:
            yield info.index, (f"mix_branches on a {sched.branches}-branch "
                               f"state (needs exactly 2)")
        if sched.branches == 2 and isinstance(op, S.MRMC) and op.has_rc \
                and not op.mix_branches:
            yield info.index, ("affine layer without branch mixing on a "
                               "2-branch state (PASTA couples branches at "
                               "every affine layer)")
        if sched.init == "key" and isinstance(op, S.ARK):
            yield info.index, ("ARK inside a keyed-init (init='key') "
                               "program")
    if sched.init not in ("ic", "key"):
        yield None, f"unknown init {sched.init!r}"


@rule("SA108", "rc-storage-perm")
def _check_rc_storage_perm(sched, table):
    """The kernel FIFO reorder must be a true permutation that stays inside
    each constant slice AND inside each branch's half of a slice — a
    constant crossing either boundary would be delivered to the wrong
    datapath element (or the wrong branch matrix) in storage order."""
    try:
        perm = sched.rc_storage_perm()
    except Exception as e:  # malformed accounting upstream
        yield None, f"rc_storage_perm() raised: {e}"
        return
    if perm is None:
        return
    n_rc = len(perm)
    if sorted(perm) != list(range(n_rc)):
        yield None, "rc storage reorder is not a permutation"
        return
    t = sched.n // sched.branches
    for info, (a, b) in _rc_ops(table):
        if b > n_rc or a < 0:
            continue  # SA101's finding
        seg = perm[a:b] - a
        if (seg < 0).any() or (seg >= b - a).any():
            yield info.index, "storage reorder leaks outside the rc slice"
            continue
        if sched.branches > 1 and b - a == sched.n:
            for br in range(sched.branches):
                part = seg[br * t:(br + 1) * t]
                if ((part < br * t) | (part >= (br + 1) * t)).any():
                    yield info.index, (
                        f"storage reorder crosses the branch boundary in "
                        f"branch {br}'s half of the slice")
                    break


@rule("SA109", "op-fields")
def _check_op_fields(sched, table):
    """Enum-valued op fields must be in range: orientations from
    ORIENTATIONS, nonlinearity kind from {cube, feistel} — the executors
    silently fall through on unknown values."""
    for info in table:
        op = info.op
        if op.orientation not in S.ORIENTATIONS:
            yield info.index, f"unknown orientation {op.orientation!r}"
        if isinstance(op, S.MRMC) and op.out_orientation not in S.ORIENTATIONS:
            yield info.index, \
                f"unknown out_orientation {op.out_orientation!r}"
        if isinstance(op, S.NONLINEAR) and op.kind not in ("cube", "feistel"):
            yield info.index, f"unknown nonlinearity {op.kind!r}"


@rule("SA110", "mat-plane-shape")
def _check_mat_plane_shape(sched, table):
    """Stream-sourced matrix ops must carry a well-formed plane slice:
    matrix_source in range, slice width == branches*t^2 (one dense t x t
    block per branch), slices consumed contiguously in matrix-FIFO order,
    and static-matrix ops carrying no slice at all — a malformed slice
    would feed an op the wrong (or another op's) streamed matrix."""
    cursor = 0
    for info in table:
        op = info.op
        if not isinstance(op, S.MRMC):
            continue
        if op.matrix_source not in ("static", "stream"):
            yield info.index, \
                f"unknown matrix_source {op.matrix_source!r}"
            continue
        if not op.streams_matrix:
            if op.mat_slice != (0, 0):
                yield info.index, (f"static-matrix op carries mat_slice "
                                   f"{op.mat_slice} (must be (0, 0))")
            continue
        a, b = op.mat_slice
        want = info.in_width * (info.in_width // sched.branches)
        if a < 0 or b - a != want:
            yield info.index, (
                f"mat_slice [{a}, {b}) is {b - a} words, need "
                f"branches*t^2 = {want} (one dense t x t per branch)")
        if a != cursor:
            yield info.index, (
                f"mat_slice starts at {a} but the matrix FIFO cursor is "
                f"at {cursor} — planes must be consumed in stream order")
        cursor = max(cursor, b)


@rule("SA111", "terminal-reduction")
def _check_terminal_reduction(sched, table, plan=None):
    """The terminal-reduction law (docs/DESIGN.md §14): under ANY
    reduction plan the state must be fully reduced (< q) entering every
    TRUNCATE and AGN and at program end — keystream bytes are defined as
    canonical residues, so a reduce deferred past an output boundary
    emits wrong answers, not just different scheduling.  Plan-aware: only
    checks when `lint(sched, plan=...)` supplies the active plan."""
    if plan is None:
        return
    if len(plan.ops) != len(sched.ops):
        yield None, (f"reduction plan has {len(plan.ops)} op entries for a "
                     f"{len(sched.ops)}-op program (stale plan)")
        return
    for idx, what, bound in plan.terminal_sites(sched):
        if bound > plan.q:
            yield idx, (f"{what} bound {bound} > q={plan.q} under the "
                        f"{plan.mode!r} plan — a reduce is deferred past "
                        f"the output boundary (terminal-reduction law)")


@rule("SA201", "vacuous-variant", severity=WARNING)
def _check_vacuous_variant(sched, table):
    """An 'alternating' variant that never actually flips is vacuously
    equal to 'normal' — the orientation property tests pass without
    exercising any transposed code path (a coverage trap, not a bug)."""
    if sched.variant == "alternating" and not sched.has_transposed_ops:
        yield None, ("alternating variant contains no transposed op; the "
                     "flip plan is vacuous")
