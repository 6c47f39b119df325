"""Analytic cost model: walk the program, predict per-engine ceilings.

The port's copy of `repro.analysis.cost`.  The static counts are the
reference's, word for word (they describe the limb-scheme program, with
constants counted as 4-byte words, so they match its snapshot); the
machine models and engine profiles are the port's: the H100's rates and
an eager dispatch cost measured on the card for ``cuda``, and the port's
two engines, ``ref`` (plain PyTorch, one launch per primitive) and
``cuda`` (the fused keystream kernel).

The DaCe ``RooflineModel`` shape (SNIPPETS §2-3): analyze the IR, not the
runtime.  One walk of a `Schedule` yields exact static counts — modular
multiplies (the limb-scheme hot op), reduced adds, conditional-subtract
steps, shift-add chain adds (T4's multiplier-free linear layers), traced
call sites, and bytes moved per lane — from which per-engine roofline
ceilings follow: an engine's throughput is capped by
``min(compute ceiling, memory ceiling)`` under its execution profile
(eager per-site dispatch for ``ref``, one fused kernel for ``cuda``).

The model is validated against MEASURED `StreamPlan` timings: the tuner
persists its full per-candidate table (`core/tuner.py
load_measurements`), and :func:`validate_measured_ordering` requires the
predicted per-engine ordering to match the measured one wherever the
measured gap exceeds the tolerance — predicted *ratios* are a model,
predicted *ordering* is a checkable claim.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import schedule as S
from repro_torch.core.engine import engine_caps
from repro_torch.core.params import CipherParams
from repro_torch.core.schedule import Schedule
from repro_torch.device import resolve_device

#: one full limb-scheme modmul costs about this many reduced-add
#: equivalents (3 limb products + 2 shiftLs + 4 reduce chains); used only
#: to weight the compute term — ordering, not absolute time, is the claim
MUL_WEIGHT = 12.0


# ==========================================================================
# Static counts: one walk of the program
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class CostReport:
    """Exact static per-program counts (per keystream lane unless noted)."""

    schedule: str
    n_ops: int              # program length (schedule ops)
    modmul: int             # full limb-scheme muls per lane
    modadd: int             # reduced adds per lane
    reduce_steps: int       # conditional-subtract select steps per lane
    shift_add: int          # small-constant add-chain adds per lane (T4)
    call_sites: int         # traced primitive call sites per program
    rc_per_lane: int        # round constants streamed in per lane
    bytes_in_per_lane: int
    bytes_out_per_lane: int

    @property
    def bytes_per_lane(self) -> int:
        return self.bytes_in_per_lane + self.bytes_out_per_lane

    @property
    def weighted_elem_ops(self) -> float:
        """Compute work per lane in reduced-add equivalents."""
        return (self.modmul * MUL_WEIGHT + self.modadd + self.reduce_steps
                + self.shift_add)

    @property
    def modmul_intensity(self) -> float:
        """Modular multiplies per byte moved — the cipher's signature:
        HERA's cube tower is mul-heavy, PASTA's affine layers are
        bandwidth-heavy (constants dominate), Rubato sits between."""
        return self.modmul / max(1, self.bytes_per_lane)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["bytes_per_lane"] = self.bytes_per_lane
        d["modmul_intensity"] = round(self.modmul_intensity, 6)
        d["weighted_elem_ops"] = self.weighted_elem_ops
        return d


def _row_cost(mod, row) -> Tuple[int, int, int, int]:
    """(shift_adds, acc_adds, reduce_steps, call_sites) for one shift-add
    matvec row — a replay of the `matvec_small`/`_combine` interleaved-
    reduce policy with the SAME step schedule `Modulus.reduce` executes."""
    shift_adds = acc_adds = steps = sites = 0
    bound = 0
    for c in row:
        c = int(c)
        if c == 0:
            continue
        if c > 1:
            shift_adds += c - 1
            steps += len(mod.reduce_steps(c * mod.q))
            sites += c  # add chain + reduce
        if bound == 0:
            bound = mod.q
        else:
            if bound + mod.q >= 2**32:
                steps += len(mod.reduce_steps(bound))
                sites += 1
                bound = mod.q
            acc_adds += 1
            sites += 1
            bound += mod.q
    steps += len(mod.reduce_steps(bound))
    sites += 1
    return shift_adds, acc_adds, steps, sites


def analyze_cost(params: CipherParams,
                 schedule: Optional[Schedule] = None,
                 variant: str = "normal") -> CostReport:
    """Walk ``schedule`` once and count everything the engines will do.

    Orientation is cost-free by construction (Eq. 2 flips are output
    relabelings; storage-order constants make transposed ARKs plain
    contiguous reads), so normal and alternating variants of one preset
    report identical counts — which is itself a checkable claim
    (tests/test_torch_analysis.py asserts it).
    """
    if schedule is None:
        schedule = params.schedule(variant)
    mod = params.mod
    add_steps = len(mod.reduce_steps(2 * mod.q))   # every mod.add/sub
    mat = params.mix_matrix()
    v, nb = params.v, schedule.branches

    muls = adds = steps = shift = sites = 0
    for info in schedule.op_table():
        op, w = info.op, info.in_width
        if isinstance(op, S.ARK):
            m = op.key_len
            muls += m
            adds += m
            steps += m * add_steps
            sites += 2
        elif isinstance(op, S.MRMC) and op.streams_matrix:
            # stream-sourced dense affine layer: one t x t matvec per
            # branch under the chunked-accumulate policy of
            # Modulus.matvec_dense (products < q sum raw in uint32 per
            # divisor chunk, one reduce per chunk, then one raw fold of
            # the reduced partials — Modulus.dense_chunk_schedule)
            t = w // nb
            ch, nch = mod.dense_chunk_schedule(t)
            muls += nb * t * t
            adds += nb * t * (t - nch)            # raw in-chunk sums
            adds += nb * t * (nch - 1)            # partial-sum fold
            steps += nb * t * nch * len(mod.reduce_steps(ch * mod.q))
            if nch > 1:
                steps += nb * t * len(mod.reduce_steps(nch * mod.q))
            sites += 3 + (2 if nch > 1 else 0)
            if op.has_rc:
                adds += w
                steps += w * add_steps
                sites += 1
            if op.mix_branches:
                t2 = w // 2
                adds += 3 * t2
                steps += 3 * t2 * add_steps
                sites += 3
        elif isinstance(op, S.MRMC):
            # two matvec passes (MixColumns, MixRows) per branch; each
            # pass applies every matrix row across v row-vectors of width v
            for row in mat:
                sa, aa, st, si = _row_cost(mod, row)
                muls += 0
                shift += 2 * nb * v * sa
                adds += 2 * nb * v * aa
                steps += 2 * nb * v * st
                sites += 2 * nb * si
            if op.has_rc:
                adds += w
                steps += w * add_steps
                sites += 1
            if op.mix_branches:
                t = w // 2
                adds += 3 * t
                steps += 3 * t * add_steps
                sites += 3
        elif isinstance(op, S.NONLINEAR):
            if op.kind == "cube":
                muls += 2 * w
                sites += 2
            else:  # feistel, per branch: t-1 squares + t adds
                t = w // nb
                muls += nb * (t - 1)
                adds += nb * t
                steps += nb * t * add_steps
                sites += 2 * nb
        elif isinstance(op, S.AGN):
            # signed fold is a where-select (lands in [0, q), no reduce);
            # the one reduced add is the only reduce this path needs
            adds += w
            steps += w * add_steps
            sites += 2
    noise_bytes = 4 * params.l if params.n_noise else 0
    mat_bytes = 4 * schedule.n_matrix_constants   # streamed matrix planes
    return CostReport(
        schedule=schedule.name,
        n_ops=len(schedule.ops),
        modmul=muls, modadd=adds, reduce_steps=steps, shift_add=shift,
        call_sites=sites,
        rc_per_lane=schedule.n_round_constants,
        bytes_in_per_lane=4 * schedule.n_round_constants + noise_bytes
        + mat_bytes,
        bytes_out_per_lane=4 * params.l,
    )


# ==========================================================================
# Reduction-schedule accounting: eager vs lazy conditional-subtract steps
# ==========================================================================
def _row_reduce_steps(mod, row, in_bound: int, lazy: bool) -> int:
    """Conditional-subtract steps ONE shift-add matvec row fires under the
    eager or lazy accumulate policy — a steps-only replay of the walk
    `Modulus.matvec_small` / `accumulate_sites` share."""
    steps = 0
    bound = 0
    for c in row:
        c = int(c)
        if c == 0:
            continue
        if lazy:
            tb = c * in_bound          # raw add chain, no per-term reduce
        else:
            tb = mod.q
            if c > 1:
                steps += len(mod.reduce_steps(c * mod.q))
        if bound == 0:
            bound = tb
        else:
            if bound + tb >= 2**32:
                steps += len(mod.reduce_steps(bound))
                bound = mod.q
            bound += tb
    steps += len(mod.reduce_steps(bound))   # terminal row reduce
    return steps


def count_reduce_steps(params: CipherParams, schedule: Schedule,
                       plan) -> int:
    """Total conditional-subtract select steps per keystream lane when the
    program executes under ``plan`` (a `core.redplan.ReductionPlan`) —
    including the limb-internal reduces of every modular multiply
    (`Modulus.mul_reduce_steps`), replayed from the same static step
    schedules the datapath fires."""
    from repro_torch.core import redplan as RP

    mod = params.mod
    q = mod.q
    add_steps = len(mod.reduce_steps(2 * q))
    mat = params.mix_matrix()
    v, nb = params.v, schedule.branches
    total = 0
    for i, info in enumerate(schedule.op_table()):
        op, w = info.op, info.in_width
        p = plan.ops[i]
        in_b = p.in_bound
        if isinstance(op, S.ARK):
            m = op.key_len
            total += m * mod.mul_reduce_steps()       # k (.) rc limb mul
            if not p.has(RP.DEFER_OUT):
                total += m * len(mod.reduce_steps(in_b + q))
        elif isinstance(op, S.MRMC) and op.streams_matrix:
            t = w // nb
            lazy_d = p.has(RP.LAZY_DENSE)
            per_mul = mod.mul_reduce_steps(
                None, in_b if lazy_d else None, reduce_out=not lazy_d)
            total += nb * t * t * per_mul
            pb = 3 * q if lazy_d else q
            ch, nch = mod.dense_chunk_schedule(t, pb)
            total += nb * t * nch * len(mod.reduce_steps(ch * pb))
            if nch > 1:
                total += nb * t * len(mod.reduce_steps(nch * q))
            fold = p.has(RP.FOLD_MIX)
            if op.has_rc and not fold:
                total += w * add_steps
            if op.mix_branches:
                t2 = w // 2
                if fold:
                    mix_in = 2 * q if op.has_rc else q
                    total += 2 * t2 * len(mod.reduce_steps(3 * mix_in))
                else:
                    total += 3 * t2 * add_steps
        elif isinstance(op, S.MRMC):
            lazy_a = p.has(RP.LAZY_ACCUMULATE)
            for row in mat:
                # first pass sees operands < in_b; its rows reduce
                # terminally, so the second pass runs from q
                total += nb * v * (
                    _row_reduce_steps(mod, row, in_b, lazy_a)
                    + _row_reduce_steps(mod, row, q, lazy_a))
            if op.has_rc:
                total += w * add_steps
            if op.mix_branches:
                total += 3 * (w // 2) * add_steps
        elif isinstance(op, S.NONLINEAR):
            if op.kind == "cube":
                total += 2 * w * mod.mul_reduce_steps()
            else:
                t = w // nb
                total += nb * (t - 1) * mod.mul_reduce_steps()
                total += nb * t * len(mod.reduce_steps(in_b + q))
        elif isinstance(op, S.AGN):
            total += w * add_steps
    return total


@dataclasses.dataclass(frozen=True)
class ReductionReport:
    """Eager vs lazy conditional-subtract totals for one program — the
    reduction-scheduling pass's measurable static win, surfaced in the
    analysis snapshot (`repro_torch.analysis.__main__`)."""

    schedule: str
    eager_steps: int        # per lane, everything-reduced plan
    lazy_steps: int         # per lane, shipped lazy plan

    @property
    def saved_steps(self) -> int:
        return self.eager_steps - self.lazy_steps

    @property
    def saved_pct(self) -> float:
        return 100.0 * self.saved_steps / max(1, self.eager_steps)

    def to_json(self) -> dict:
        return {
            "schedule": self.schedule,
            "eager_steps": self.eager_steps,
            "lazy_steps": self.lazy_steps,
            "saved_steps": self.saved_steps,
            "saved_pct": round(self.saved_pct, 3),
        }

    def render(self) -> str:
        return (f"reduction {self.schedule}: eager {self.eager_steps} -> "
                f"lazy {self.lazy_steps} cond-subtract steps/lane "
                f"(-{self.saved_steps}, {self.saved_pct:.1f}% saved)")


def reduction_report(params: CipherParams,
                     schedule: Optional[Schedule] = None,
                     variant: str = "normal") -> ReductionReport:
    """Count the program's conditional-subtract steps under the eager and
    lazy reduction plans (`core/redplan.py`) and report the delta.  The
    lazy plan is the shipped default datapath, so ``saved_steps`` is the
    static reduce-work the pass actually removed."""
    from repro_torch.core.redplan import plan_reductions

    if schedule is None:
        schedule = params.schedule(variant)
    eager = count_reduce_steps(
        params, schedule, plan_reductions(params, schedule, "eager"))
    lazy = count_reduce_steps(
        params, schedule, plan_reductions(params, schedule, "lazy"))
    return ReductionReport(schedule=schedule.name, eager_steps=eager,
                           lazy_steps=lazy)


# ==========================================================================
# Machine + engine profiles -> roofline ceilings
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class MachineModel:
    """Sustained rates the ceilings are computed against.  Deterministic
    per device type (cpu/cuda) so snapshots compare stably across hosts
    of the same kind; absolute accuracy is NOT the claim — measured
    validation is ordering-only."""

    name: str
    elem_ops_per_s: float    # sustained u32 elementwise ops (add-equiv)
    mem_bw: float            # bytes/s
    dispatch_s: float        # per traced-primitive eager dispatch cost

    @classmethod
    def for_backend(cls, device=None) -> "MachineModel":
        """The model for ``device``'s type ("cpu" or "cuda"); None means
        the card, as every entry point of the port."""
        kind = (resolve_device(None) if device is None
                else torch.device(device)).type
        if kind == "cuda":
            # one NVIDIA H100 80GB HBM3 at its 700.00 W limit: the peaks
            # chip_smoke.py's bounds use (132 SMs x 64 INT32 lanes x ~1.98
            # GHz; 3.35 TB/s of HBM3, NVIDIA's data sheet) and the eager
            # dispatch cost chip_smoke.py measures there
            return cls(name="cuda", elem_ops_per_s=16.7e12, mem_bw=3.35e12,
                       dispatch_s=CUDA_DISPATCH_S)
        return cls(name="cpu", elem_ops_per_s=5e9, mem_bw=2e10,
                   dispatch_s=20e-6)


#: Seconds per eager PyTorch launch on the card: the median of the 9
#: samples (2000 one-launch int64 adds from the host each) that
#: chip_smoke.py's "eager dispatch" line took in one run on an NVIDIA H100
#: 80GB HBM3 at 700.00 W; its samples spread 9.18-10.59 us, and single
#: 5000-launch samples of other runs on that card read 7.17 and 11.98 us.
#: The model uses it to order engines, which a spread this size cannot
#: change (`ref` is charged it at each of hundreds of call sites).
CUDA_DISPATCH_S = 9.835e-6


@dataclasses.dataclass(frozen=True)
class EngineProfile:
    """How one registered engine maps static counts to time."""

    name: str
    eager_dispatch: bool = False    # pays dispatch_s per call site per op
    fused_io: bool = True           # False: intermediate HBM round trips


ENGINE_PROFILES: Dict[str, EngineProfile] = {
    # plain PyTorch: one launch per primitive, every intermediate through
    # memory
    "ref": EngineProfile(name="ref", eager_dispatch=True, fused_io=False),
    # the fused keystream kernel: constants stream in, words out
    "cuda": EngineProfile(name="cuda"),
}


@dataclasses.dataclass(frozen=True)
class EnginePrediction:
    """Predicted cost of one engine on one (program, lanes) workload."""

    engine: str
    seconds: float           # predicted wall time for the window
    compute_s: float
    memory_s: float
    dispatch_s: float
    ceiling_lanes_per_s: float   # roofline: min(compute, memory) ceiling
    bound_by: str            # "compute" | "memory" | "dispatch"

    @property
    def per_lane_s(self) -> float:
        return self.seconds

    def to_json(self) -> dict:
        return {"engine": self.engine, "seconds": self.seconds,
                "ceiling_lanes_per_s": self.ceiling_lanes_per_s,
                "bound_by": self.bound_by}


def predict_engine_times(params: CipherParams, lanes: int,
                         engines: Optional[Sequence[str]] = None,
                         variant: str = "normal",
                         machine: Optional[MachineModel] = None,
                         ) -> Dict[str, EnginePrediction]:
    """Per-engine predicted window time + roofline ceiling for ``lanes``
    keystream lanes of this preset.  Engines default to every profiled
    engine that runs on this machine's device type (``cuda`` only on the
    card)."""
    if machine is None:
        machine = MachineModel.for_backend()
    cost = analyze_cost(params, variant=variant)
    if engines is None:
        caps = engine_caps()
        engines = [n for n in ENGINE_PROFILES
                   if machine.name in caps[n].device_types]
    out: Dict[str, EnginePrediction] = {}
    for name in engines:
        prof = ENGINE_PROFILES[name]
        rate = machine.elem_ops_per_s
        t_compute = cost.weighted_elem_ops * lanes / rate
        io_factor = 1.0 if prof.fused_io else 2.0  # per-op HBM round trips
        t_memory = cost.bytes_per_lane * lanes * io_factor / machine.mem_bw
        t_dispatch = (cost.call_sites * machine.dispatch_s
                      if prof.eager_dispatch else 0.0)
        seconds = max(t_compute, t_memory) + t_dispatch
        ceiling = min(rate / cost.weighted_elem_ops,
                      machine.mem_bw / (cost.bytes_per_lane * io_factor))
        bound = max((("compute", t_compute), ("memory", t_memory),
                     ("dispatch", t_dispatch)), key=lambda kv: kv[1])[0]
        out[name] = EnginePrediction(
            engine=name, seconds=seconds, compute_s=t_compute,
            memory_s=t_memory, dispatch_s=t_dispatch,
            ceiling_lanes_per_s=ceiling, bound_by=bound,
        )
    return out


# ==========================================================================
# Validation against measured StreamPlan timings
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class OrderingPair:
    fast: str                # engine predicted faster
    slow: str
    predicted_ratio: float   # slow/fast, > 1
    measured_ratio: float    # measured slow/fast (per-lane p50)
    within_tolerance: bool   # measured gap too small to rank
    agrees: bool

    def render(self) -> str:
        if self.within_tolerance:
            return (f"  {self.fast} ~ {self.slow}: measured gap "
                    f"{self.measured_ratio:.2f}x within tolerance (unranked)")
        mark = "ok" if self.agrees else "MISMATCH"
        return (f"  {self.fast} < {self.slow}: predicted "
                f"{self.predicted_ratio:.1f}x, measured "
                f"{self.measured_ratio:.2f}x [{mark}]")


@dataclasses.dataclass(frozen=True)
class OrderingReport:
    """Did the analytic model rank the engines the way the farm measured
    them?  Pairs whose measured gap is within tolerance are unranked (a
    model should not be failed on noise)."""

    preset: str
    measured_per_lane_ms: Dict[str, float]   # best plan per engine
    predicted_per_lane_ms: Dict[str, float]
    pairs: Tuple[OrderingPair, ...]
    skipped: str = ""        # non-empty = validation had nothing to rank

    @property
    def ok(self) -> bool:
        return all(p.agrees or p.within_tolerance for p in self.pairs)

    def render(self) -> str:
        if self.skipped:
            return f"ordering {self.preset}: SKIPPED ({self.skipped})"
        lines = [f"ordering {self.preset}: "
                 f"{'ok' if self.ok else 'MISMATCH'}"]
        for eng in sorted(self.measured_per_lane_ms):
            lines.append(
                f"  {eng:18s} measured {self.measured_per_lane_ms[eng]:9.4f} "
                f"ms/lane   predicted {self.predicted_per_lane_ms[eng]:9.4f}")
        lines += [p.render() for p in self.pairs]
        return "\n".join(lines)


def validate_measured_ordering(params: CipherParams,
                               measurements: Sequence[dict],
                               tol: float = 0.2,
                               machine: Optional[MachineModel] = None,
                               ) -> OrderingReport:
    """Check the model's per-engine ordering against a measured timing
    table (rows from `core.tuner.load_measurements`: plan fields +
    ``p50_ms`` per candidate).

    Per engine the BEST measured plan is used (the tuner's own selection
    semantics), normalized to per-lane latency by its window so plans at
    different window sizes compare.  For every engine pair whose measured
    gap exceeds ``tol`` the predicted ordering must agree.
    """
    best: Dict[str, float] = {}
    for row in measurements:
        eng = row.get("engine")
        win = max(1, int(row.get("window", 1)))
        if eng is None or "p50_ms" not in row:
            continue
        per_lane = float(row["p50_ms"]) / win
        if eng not in best or per_lane < best[eng]:
            best[eng] = per_lane
    if len(best) < 2:
        return OrderingReport(
            preset=params.name, measured_per_lane_ms=best,
            predicted_per_lane_ms={}, pairs=(),
            skipped=f"need >= 2 measured engines, have {sorted(best)}")
    preds = predict_engine_times(params, lanes=1, engines=sorted(best),
                                 machine=machine)
    pred_ms = {e: p.seconds * 1e3 for e, p in preds.items()}
    pairs: List[OrderingPair] = []
    names = sorted(best)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            fast, slow = (a, b) if pred_ms[a] <= pred_ms[b] else (b, a)
            predicted_ratio = pred_ms[slow] / max(pred_ms[fast], 1e-12)
            measured_ratio = best[slow] / max(best[fast], 1e-12)
            within = max(measured_ratio, 1 / max(measured_ratio, 1e-12)) \
                <= 1 + tol
            pairs.append(OrderingPair(
                fast=fast, slow=slow, predicted_ratio=predicted_ratio,
                measured_ratio=measured_ratio, within_tolerance=within,
                agrees=measured_ratio >= 1.0,
            ))
    return OrderingReport(preset=params.name, measured_per_lane_ms=best,
                          predicted_per_lane_ms=pred_ms, pairs=tuple(pairs))
