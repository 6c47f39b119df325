"""Proof-guided lazy modular reduction: the reduction-scheduling pass.

Presto's frequency wins come from shortening the modular-arithmetic
critical path; our software analogue of that path is the branchless
conditional-subtract reduce chain (`Modulus.reduce`), which the eager
datapath fires after *every* add/mul/matvec-chunk even where uint32
headroom makes it provably unnecessary.  This pass (docs/DESIGN.md §14)
walks `Schedule.op_table()` once, propagates worst-case magnitude bounds
across consecutive ops, and emits a per-(preset, variant)
:class:`ReductionPlan`: per-op input/output bounds plus execution flags
saying where a reduce is skipped, deferred, or weakened.

The shipped lazy policy (every deferral is feasibility-checked against
the SAME `Modulus` bound enumerators the overflow proof replays, so
"proof-guided" is literal):

  * **defer-out (ARK)** — the `x + k·rc` output reduce is skipped when the
    next op is a static MRMC whose lazy shift-add accumulator provably
    absorbs < 2q operands (`Modulus.accumulate_sites(lazy=True)` all fit);
  * **lazy-accumulate (static MRMC)** — shift-add terms stay raw (no
    per-term reduce, relaxed input bound) and each row fires ONE terminal
    reduce (`Modulus.matvec_small(lazy=True)`);
  * **lazy-dense (stream MRMC)** — the dense matvec's t² per-product
    final reduces are deferred (`mul(reduce_out=False)`, products < 3q)
    with the chunk width recomputed by `dense_chunk_schedule(t, 3q)`
    (`Modulus.matvec_dense(lazy=True)`) — the dominant PASTA win;
  * **fold-mix (affine MRMC)** — the additive-constant add and PASTA's
    branch mix `(s+L, s+R)` run raw, folding three eager reduces into one
    terminal reduce from 3·(matrix_out + rc) — requires `mix_branches`.

NONLINEAR and every op feeding TRUNCATE/AGN/program-end emit fully
reduced state — the **terminal-reduction law** (lint rule SA111), which
:meth:`ReductionPlan.validate` enforces and `analysis/bounds.py`
discharges as an obligation per terminal site.  Bit-exactness is free:
every reduce chain lands on the canonical residue in [0, q) regardless
of where it fires, so lazy ≡ eager on every program (the golden digests
do not move).

Interpreters honoring the plan: the plain `execute_schedule`
(core/schedule.py) through the bound-carrying matvec variants of
crypto/modmath.py, and the CUDA keystream kernel, whose op table carries
the flags (kernels/keystream/ops.py; it accumulates in 64 bits, so the
flags pick its datapath and the words are the same either way).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

from repro_torch.core import schedule as S

#: the two reduction-scheduling modes every engine/tuner knob accepts
REDUCTION_MODES = ("eager", "lazy")
DEFAULT_REDUCTION = "lazy"

#: per-op execution-choice flags (see module docstring)
DEFER_OUT = "defer-out"
LAZY_ACCUMULATE = "lazy-accumulate"
LAZY_DENSE = "lazy-dense"
FOLD_MIX = "fold-mix"


@dataclasses.dataclass(frozen=True)
class OpPlan:
    """Reduction schedule for one op: exclusive worst-case value bounds on
    its input/output state plus the execution flags the interpreters
    honor.  Bounds are multiples of q as plain ints (q = fully reduced)."""

    index: int
    in_bound: int
    out_bound: int
    flags: Tuple[str, ...] = ()

    def has(self, flag: str) -> bool:
        return flag in self.flags


@dataclasses.dataclass(frozen=True)
class ReductionPlan:
    """A complete per-program reduction schedule (one OpPlan per op)."""

    schedule: str          # Schedule.name the plan was derived for
    mode: str              # "eager" | "lazy"
    q: int
    ops: Tuple[OpPlan, ...]

    def op(self, index: int) -> OpPlan:
        return self.ops[index]

    def terminal_sites(self, sched: S.Schedule) -> Tuple[tuple, ...]:
        """(op_index | None, description, bound) for every point the
        terminal-reduction law constrains: the input of each TRUNCATE and
        AGN, and the program's final output.  Shared by
        :meth:`validate`, lint rule SA111, and the bounds prover."""
        sites = []
        for i, op in enumerate(sched.ops):
            if isinstance(op, (S.TRUNCATE, S.AGN)):
                kind = type(op).__name__
                sites.append((i, f"{kind} input", self.ops[i].in_bound))
        if self.ops:
            sites.append((None, "program output", self.ops[-1].out_bound))
        return tuple(sites)

    def validate(self, sched: S.Schedule) -> "ReductionPlan":
        """Enforce the terminal-reduction law (SA111): state must be fully
        reduced (< q) before TRUNCATE/AGN and at program end under ANY
        plan.  Raises ValueError on an over-deferred plan."""
        if len(self.ops) != len(sched.ops):
            raise ValueError(
                f"plan for {self.schedule} has {len(self.ops)} op entries, "
                f"schedule {sched.name} has {len(sched.ops)} ops")
        for idx, what, bound in self.terminal_sites(sched):
            if bound > self.q:
                where = f"ops[{idx}]" if idx is not None else "end"
                raise ValueError(
                    f"terminal-reduction law violated at {where} "
                    f"({sched.name}): {what} bound {bound} > q={self.q} — "
                    "the plan defers a reduce past the output boundary")
        return self

    def describe(self) -> str:
        lines = [f"reduction plan {self.schedule} [{self.mode}]"]
        for p in self.ops:
            flags = ",".join(p.flags) or "-"
            lines.append(f"  ops[{p.index:2d}]  in<{p.in_bound // self.q}q "
                         f"out<{p.out_bound // self.q}q  {flags}")
        return "\n".join(lines)


def _lazy_rows_fit(mod, mat, in_bound: int) -> bool:
    """True iff every row of the small mix matrix survives the lazy
    accumulate walk at the given operand bound — checked against the same
    site enumeration the overflow proof discharges."""
    return all(
        site.ok
        for row in mat
        for site in mod.accumulate_sites(row, in_bound=in_bound, lazy=True)
    )


@functools.lru_cache(maxsize=None)
def plan_reductions(params, schedule: S.Schedule | None = None,
                    mode: str = DEFAULT_REDUCTION) -> ReductionPlan:
    """Derive the reduction plan for one (preset, variant) program.

    ``mode="eager"`` yields the legacy everything-reduced plan (all bounds
    q, no flags — interpreters honoring it emit the pre-pass graphs).
    ``mode="lazy"`` applies the policy in the module docstring, deferring
    only where the corresponding `Modulus` feasibility check discharges.
    The result is deterministic in (params, schedule, mode), so engines
    carry the *mode string* and rebuild (cached) plans where they run.
    """
    if mode not in REDUCTION_MODES:
        raise ValueError(f"unknown reduction mode {mode!r}; "
                         f"expected one of {REDUCTION_MODES}")
    if schedule is None:
        schedule = S.build_schedule(params)
    mod = params.mod
    q = mod.q
    ops_in = schedule.ops
    if mode == "eager":
        plan_ops = tuple(OpPlan(i, q, q) for i in range(len(ops_in)))
        return ReductionPlan(schedule=schedule.name, mode=mode, q=q,
                             ops=plan_ops).validate(schedule)

    mat = params.mix_matrix()
    plan_ops = []
    bound = q                       # initial state (ic or key) is reduced
    for i, op in enumerate(ops_in):
        in_b = bound
        flags = []
        out_b = q                   # default: op emits reduced state
        if isinstance(op, S.ARK):
            nxt = ops_in[i + 1] if i + 1 < len(ops_in) else None
            if (isinstance(nxt, S.MRMC) and not nxt.streams_matrix
                    and _lazy_rows_fit(mod, mat, in_b + q)):
                # x (< in_b) + k·rc (< q) flows raw into the shift-add
                # MRMC accumulator with recomputed thresholds
                flags.append(DEFER_OUT)
                out_b = in_b + q
        elif isinstance(op, S.MRMC):
            if op.streams_matrix:
                # deferred products are < 3q < 2^30, always chunkable; a
                # relaxed state bound must clear the limb multiply
                if mod.mul_fits(q, in_b):
                    flags.append(LAZY_DENSE)
                if op.mix_branches:
                    mix_in = 2 * q if op.has_rc else q
                    if 3 * mix_in < 2**32:
                        flags.append(FOLD_MIX)
            elif _lazy_rows_fit(mod, mat, in_b):
                flags.append(LAZY_ACCUMULATE)
        # NONLINEAR / TRUNCATE / AGN execute eagerly on reduced state:
        # relaxed Feistel squares cost more limb-internal reduce steps
        # than the deferred adds save (DESIGN.md §14), and the terminal
        # ops are constrained by the terminal-reduction law anyway.
        if in_b > q and not flags:
            raise AssertionError(
                f"reduction planner deferred {in_b} into ops[{i}] of "
                f"{schedule.name} without a feasible lazy policy")
        plan_ops.append(OpPlan(i, in_b, out_b, tuple(flags)))
        bound = out_b
    return ReductionPlan(schedule=schedule.name, mode=mode, q=q,
                         ops=tuple(plan_ops)).validate(schedule)
