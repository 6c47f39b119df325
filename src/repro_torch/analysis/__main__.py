"""Command-line entry point of the port's schedule-IR static analyzers.

Examples (``--device cpu`` on a host without a card; the default is the
card, which the measured depth and the machine model run on)::

    PYTHONPATH=src python -m repro_torch.analysis pasta-128l
    PYTHONPATH=src python -m repro_torch.analysis hera-128a --variant alternating
    PYTHONPATH=src python -m repro_torch.analysis --all --format json
    PYTHONPATH=src python -m repro_torch.analysis --all --check   # drift gate
    PYTHONPATH=src python -m repro_torch.analysis --all --write-snapshot \
        --snapshot /tmp/analysis.json
    PYTHONPATH=src python -m repro_torch.analysis rubato-128s --validate-ordering

``--check`` compares against the JAX package's checked-in snapshot
(`benchmarks/BENCH_schedule_analysis.json`, read only) by default: its
analytic fields (lint, proofs, depths, static counts) must match exactly.
Predictions and measured timings are compared only against a snapshot
this CLI wrote, on the same device type.  ``--write-snapshot`` needs an
explicit ``--snapshot`` path outside ``benchmarks/``.

Exit status is 0 only when every requested claim holds: no lint errors,
every overflow obligation proved, static == paper == measured depth, and
(when requested) predicted engine ordering matching the measured plans /
snapshot analytic fields matching exactly.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.analysis.bounds import depth_report, prove_overflow_safety
from repro_torch.analysis.cost import (
    MachineModel,
    analyze_cost,
    predict_engine_times,
    reduction_report,
    validate_measured_ordering,
)
from repro_torch.analysis.lint import ERROR, lint
from repro_torch.core.params import REGISTRY, get_params
from repro_torch.core.redplan import plan_reductions
from repro_torch.core.schedule import VARIANTS

#: 1 = initial analytic matrix; 2 = reduction-scheduling pass (per-variant
#: "reduction" eager-vs-lazy cond-subtract deltas + lazy-plan overflow
#: proofs; lint now runs against the shipped lazy plan so SA111 is live)
SNAPSHOT_SCHEMA = 2
#: snapshots this CLI writes carry this tag; the JAX package's do not
PACKAGE = "repro_torch"
BENCHMARKS = pathlib.Path(__file__).resolve().parents[3] / "benchmarks"
DEFAULT_SNAPSHOT = BENCHMARKS / "BENCH_schedule_analysis.json"
#: relative drift in measured per-lane p50 that --check flags
MEASURED_DRIFT_TOL = 0.20


def analyze_one(name: str, variant: str, measure: bool = True,
                device=None) -> dict:
    """Run all three analyzers on one (preset, variant); JSON-able dict."""
    params = get_params(name)
    sched = params.schedule(variant)
    lazy_plan = plan_reductions(params, sched, "lazy")
    findings = lint(sched, plan=lazy_plan)
    proof = prove_overflow_safety(params, sched, reduction="eager")
    lazy_proof = prove_overflow_safety(params, sched, plan=lazy_plan)
    depth = depth_report(params, variant, measure=measure, device=device)
    cost = analyze_cost(params, sched)
    red = reduction_report(params, sched)

    def proof_json(p):
        return {
            "proved": p.proved,
            "n_checks": len(p.checks),
            "min_margin_bits": round(p.min_margin_bits, 4),
            "tightest": (f"{p.tightest.provenance} :: "
                         f"{p.tightest.site}"),
            "failures": [c.render() for c in p.failures()],
        }

    return {
        "preset": name,
        "variant": variant,
        "lint": {
            "errors": [f.render() for f in findings
                       if f.severity == ERROR],
            "warnings": [f.render() for f in findings
                         if f.severity != ERROR],
        },
        "overflow": proof_json(proof),
        "overflow_lazy": proof_json(lazy_proof),
        "depth": {
            "static": depth.static,
            "paper": depth.paper,
            "measured": depth.measured,
            "ok": depth.ok,
        },
        "cost": cost.to_json(),
        "reduction": red.to_json(),
        "ok": (not findings or all(f.severity != ERROR
                                   for f in findings))
        and proof.proved and lazy_proof.proved and depth.ok,
    }


def render_table(res: dict) -> str:
    lines = [f"== {res['preset']}/{res['variant']} "
             f"[{'ok' if res['ok'] else 'FAIL'}] =="]
    le, lw = res["lint"]["errors"], res["lint"]["warnings"]
    lines.append(f"  lint: {len(le)} error(s), {len(lw)} warning(s)")
    lines += [f"    {m}" for m in le + lw]
    for mode in ("overflow", "overflow_lazy"):
        ov = res[mode]
        tag = "overflow[lazy]" if mode == "overflow_lazy" else "overflow"
        lines.append(
            f"  {tag}: {'PROVED' if ov['proved'] else 'UNPROVEN'} "
            f"({ov['n_checks']} obligations, min margin "
            f"{ov['min_margin_bits']:+.2f} bits at {ov['tightest']})")
        lines += [f"    {m}" for m in ov["failures"]]
    d = res["depth"]
    m = "-" if d["measured"] is None else d["measured"]
    lines.append(f"  depth: static={d['static']} paper={d['paper']} "
                 f"measured={m} [{'ok' if d['ok'] else 'MISMATCH'}]")
    c = res["cost"]
    lines.append(
        f"  cost/lane: {c['modmul']} modmul, {c['modadd']} modadd, "
        f"{c['reduce_steps']} reduce steps, {c['shift_add']} shift-adds, "
        f"{c['bytes_per_lane']} B moved "
        f"(intensity {c['modmul_intensity']:.4f} modmul/B), "
        f"{c['call_sites']} call sites")
    r = res["reduction"]
    lines.append(
        f"  reduction: eager {r['eager_steps']} -> lazy {r['lazy_steps']} "
        f"cond-subtract steps/lane (-{r['saved_steps']}, "
        f"{r['saved_pct']:.1f}% saved)")
    return "\n".join(lines)


# ==========================================================================
# Snapshot (benchmarks/BENCH_schedule_analysis.json)
# ==========================================================================
def build_snapshot(measure: bool, lanes: int, device=None) -> dict:
    """Full preset x variant analytic matrix + predicted ceilings +
    whatever measured tuner tables exist in the plan cache, for
    ``device``."""
    from repro_torch.core.tuner import load_measurements

    machine = MachineModel.for_backend(device)
    presets: dict = {}
    for name in sorted(REGISTRY):
        params = get_params(name)
        variants = {v: analyze_one(name, v, measure=measure, device=device)
                    for v in VARIANTS}
        preds = predict_engine_times(params, lanes=1, machine=machine)
        measured = {}
        for row in load_measurements(params, lanes=lanes, device=device):
            eng = row.get("engine")
            win = max(1, int(row.get("window", 1)))
            if eng is None or "p50_ms" not in row:
                continue
            per_lane = float(row["p50_ms"]) / win
            if eng not in measured or per_lane < measured[eng]:
                measured[eng] = per_lane
        presets[name] = {
            "variants": variants,
            "predicted": {e: p.to_json() for e, p in sorted(preds.items())},
            "measured_p50_ms_per_lane": {e: round(t, 6)
                                         for e, t in sorted(measured.items())},
        }
    return {
        "schema": SNAPSHOT_SCHEMA,
        "package": PACKAGE,
        "backend": machine.name,
        "lanes": lanes,
        "presets": presets,
    }


def check_snapshot(snapshot: dict, current: dict, strict: bool) -> list:
    """Compare a stored snapshot against the current analysis.

    Analytic fields (lint counts, proof status/obligation count/margins,
    depths, cost counters) are deterministic and must match EXACTLY, in a
    snapshot of either package.  Predicted ceilings and measured timings
    depend on the engines and the machine: they compare only against a
    snapshot this CLI wrote on the same device type.  Measured p50 drift
    beyond MEASURED_DRIFT_TOL is a warning — an error only under --strict.
    Returns a list of (level, message); level in {"error", "warning"}.
    """
    problems: list = []
    same_backend = (snapshot.get("package") == PACKAGE
                    and snapshot.get("backend") == current.get("backend"))
    if snapshot.get("schema") != SNAPSHOT_SCHEMA:
        return [("error", f"snapshot schema {snapshot.get('schema')} != "
                 f"{SNAPSHOT_SCHEMA}; regenerate with --write-snapshot")]
    for name, snap in sorted(snapshot.get("presets", {}).items()):
        cur = current["presets"].get(name)
        if cur is None:
            problems.append(("error", f"{name}: preset vanished from "
                             "REGISTRY but is in the snapshot"))
            continue
        for variant, sv in sorted(snap.get("variants", {}).items()):
            cv = cur["variants"].get(variant)
            if cv is None:
                problems.append(("error", f"{name}/{variant}: variant "
                                 "missing from current analysis"))
                continue
            for path, get in (
                ("lint errors", lambda r: len(r["lint"]["errors"])),
                ("lint warnings", lambda r: len(r["lint"]["warnings"])),
                ("overflow proved", lambda r: r["overflow"]["proved"]),
                ("overflow n_checks", lambda r: r["overflow"]["n_checks"]),
                ("overflow min_margin_bits",
                 lambda r: r["overflow"]["min_margin_bits"]),
                ("overflow_lazy proved",
                 lambda r: r["overflow_lazy"]["proved"]),
                ("overflow_lazy n_checks",
                 lambda r: r["overflow_lazy"]["n_checks"]),
                ("overflow_lazy min_margin_bits",
                 lambda r: r["overflow_lazy"]["min_margin_bits"]),
                ("reduction", lambda r: r["reduction"]),
                ("depth static", lambda r: r["depth"]["static"]),
                ("depth paper", lambda r: r["depth"]["paper"]),
                ("cost", lambda r: {k: v for k, v in r["cost"].items()
                                    if k != "modmul_intensity"}),
            ):
                want, got = get(sv), get(cv)
                if want != got:
                    problems.append(
                        ("error", f"{name}/{variant}: {path} drifted: "
                         f"snapshot {want!r} != current {got!r}"))
        if same_backend:
            for eng, sp in sorted(snap.get("predicted", {}).items()):
                cp = cur["predicted"].get(eng)
                if cp is None:
                    problems.append(("warning", f"{name}: engine {eng} no "
                                     "longer predicted on this backend"))
                    continue
                for field in ("ceiling_lanes_per_s", "bound_by"):
                    if sp.get(field) != cp.get(field):
                        problems.append(
                            ("error", f"{name}: predicted {eng}.{field} "
                             f"drifted: {sp.get(field)!r} != "
                             f"{cp.get(field)!r}"))
        if not same_backend:
            continue
        for eng, ms in sorted(
                snap.get("measured_p50_ms_per_lane", {}).items()):
            cm = cur["measured_p50_ms_per_lane"]
            if eng not in cm:
                problems.append(("warning", f"{name}: no current measured "
                                 f"timing for {eng} (plan cache empty?)"))
                continue
            drift = abs(cm[eng] - ms) / max(ms, 1e-12)
            if drift > MEASURED_DRIFT_TOL:
                level = "error" if strict else "warning"
                problems.append(
                    (level, f"{name}: measured {eng} p50/lane drifted "
                     f"{drift * 100:.0f}% (snapshot {ms:.4f} ms, "
                     f"now {cm[eng]:.4f} ms)"))
    return problems


# ==========================================================================
# Entry point
# ==========================================================================
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static analysis of schedule-IR cipher programs: "
                    "lint, overflow/depth proofs, analytic roofline.")
    ap.add_argument("preset", nargs="?", choices=sorted(REGISTRY),
                    help="one preset; or use --all")
    ap.add_argument("--all", action="store_true",
                    help="analyze every preset in the registry")
    ap.add_argument("--variant", choices=list(VARIANTS) + ["all"],
                    default="all", help="schedule variant (default: all)")
    ap.add_argument("--format", choices=("table", "json"), default="table")
    ap.add_argument("--no-measure", action="store_true",
                    help="skip the measured FV-depth cross-check (fast)")
    ap.add_argument("--check", action="store_true",
                    help="compare against the checked-in snapshot; exit 1 "
                         "on analytic drift")
    ap.add_argument("--strict", action="store_true",
                    help="with --check: measured-timing drift is an error")
    ap.add_argument("--write-snapshot", action="store_true",
                    help="write a snapshot to --snapshot PATH (required; "
                         "never under benchmarks/)")
    ap.add_argument("--snapshot", type=pathlib.Path, default=None,
                    metavar="PATH",
                    help=f"snapshot to check (default {DEFAULT_SNAPSHOT}) "
                         "or to write")
    ap.add_argument("--validate-ordering", action="store_true",
                    help="check predicted vs measured engine ordering "
                         "from the tuner's cached measurement tables")
    ap.add_argument("--lanes", type=int, default=8,
                    help="lane count for measurement lookup (default 8)")
    ap.add_argument("--tol", type=float, default=0.2,
                    help="measured-gap tolerance for ordering (default 0.2)")
    ap.add_argument("--device", default=None,
                    help="device for the measured depth, the machine model "
                         "and the tuner's measurements (default: the card)")
    args = ap.parse_args(argv)
    if args.write_snapshot:
        if args.snapshot is None:
            ap.error("--write-snapshot needs an explicit --snapshot PATH")
        if args.snapshot.resolve().is_relative_to(BENCHMARKS):
            ap.error(f"refusing to write {args.snapshot}: benchmarks/ holds "
                     "the JAX package's snapshots")
    elif args.snapshot is None:
        args.snapshot = DEFAULT_SNAPSHOT

    if not args.preset and not args.all:
        ap.error("give a preset name or --all")
    names = sorted(REGISTRY) if args.all else [args.preset]
    variants = list(VARIANTS) if args.variant == "all" else [args.variant]
    measure = not args.no_measure

    if args.check or args.write_snapshot:
        current = build_snapshot(measure=measure, lanes=args.lanes,
                                 device=args.device)
        if args.write_snapshot:
            args.snapshot.write_text(
                json.dumps(current, indent=1, sort_keys=True) + "\n")
            print(f"wrote {args.snapshot}")
            bad = [n for n, p in current["presets"].items()
                   for v in p["variants"].values() if not v["ok"]]
            return 1 if bad else 0
        if not args.snapshot.exists():
            print(f"snapshot {args.snapshot} missing; run --write-snapshot",
                  file=sys.stderr)
            return 1
        snapshot = json.loads(args.snapshot.read_text())
        problems = check_snapshot(snapshot, current, strict=args.strict)
        for level, msg in problems:
            print(f"[{level}] {msg}")
        errors = [m for level, m in problems if level == "error"]
        analytic_ok = all(v["ok"] for p in current["presets"].values()
                          for v in p["variants"].values())
        print(f"snapshot check: {len(errors)} error(s), "
              f"{len(problems) - len(errors)} warning(s); analytic "
              f"matrix {'ok' if analytic_ok else 'FAIL'}")
        return 0 if not errors and analytic_ok else 1

    results = [analyze_one(n, v, measure=measure, device=args.device)
               for n in names for v in variants]
    ok = all(r["ok"] for r in results)

    ordering_reports = []
    if args.validate_ordering:
        from repro_torch.core.tuner import load_measurements

        for n in names:
            params = get_params(n)
            rows = load_measurements(params, lanes=args.lanes,
                                     device=args.device)
            ordering_reports.append(validate_measured_ordering(
                params, rows, tol=args.tol,
                machine=MachineModel.for_backend(args.device)))
        ok = ok and all(r.ok or r.skipped for r in ordering_reports)

    if args.format == "json":
        out = {"results": results, "ok": ok}
        if ordering_reports:
            out["ordering"] = [
                {"preset": r.preset, "ok": r.ok, "skipped": r.skipped,
                 "measured_per_lane_ms": r.measured_per_lane_ms,
                 "predicted_per_lane_ms": r.predicted_per_lane_ms}
                for r in ordering_reports]
        print(json.dumps(out, indent=1, sort_keys=True))
    else:
        for r in results:
            print(render_table(r))
        for r in ordering_reports:
            print(r.render())
        print(f"analysis: {len(results)} program(s) "
              f"[{'ok' if ok else 'FAIL'}]")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
