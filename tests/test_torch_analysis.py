"""The port's static analysis package (`repro_torch.analysis`) against the
JAX package's, on every preset x variant: lint findings (and on the
malformed programs of tests/broken_schedules.py, rebuilt on the port's
IR), overflow proofs with every obligation and margin, static and
measured depth, static cost and reduction counts; the port's machine
models and engine profiles; and its CLI's ``--check`` against the JAX
package's checked-in snapshot."""

import dataclasses
import importlib
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from broken_schedules import ALL as BROKEN  # noqa: E402
from broken_schedules import BROKEN_PLANS  # noqa: E402

from repro.core import redplan as RRP  # noqa: E402
from repro.core.params import get_params as ref_get_params  # noqa: E402

from repro_torch.core import redplan as RP  # noqa: E402
from repro_torch.core import schedule as S  # noqa: E402
from repro_torch.core.params import REGISTRY, get_params  # noqa: E402

# the packages re-export functions named like their modules (lint)
RB, RC, RL = (importlib.import_module(f"repro.analysis.{m}")
              for m in ("bounds", "cost", "lint"))
B, C, L, cli = (importlib.import_module(f"repro_torch.analysis.{m}")
                for m in ("bounds", "cost", "lint", "__main__"))

PRESETS = sorted(REGISTRY)
VARIANTS = list(S.VARIANTS)
CASES = [(n, v) for n in PRESETS for v in VARIANTS]
IDS = [f"{n}-{v}" for n, v in CASES]
SNAPSHOT = json.loads(cli.DEFAULT_SNAPSHOT.read_text())


def to_port(obj):
    """A reference Schedule / ReductionPlan (or op) rebuilt field for field
    on the port's IR classes of the same name."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        cls = getattr(S, name, None) or getattr(RP, name)
        return cls(**{f.name: to_port(getattr(obj, f.name))
                      for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple):
        return tuple(to_port(x) for x in obj)
    return obj


def _render(findings):
    return [(f.code, f.severity, f.rule, f.message, f.schedule, f.op_index,
             f.provenance) for f in findings]


def _checks(proof):
    return [dataclasses.astuple(c) for c in proof.checks]


@pytest.mark.parametrize("name,variant", CASES, ids=IDS)
def test_lint_matches_reference(name, variant):
    p, rp = get_params(name), ref_get_params(name)
    sched, rsched = p.schedule(variant), rp.schedule(variant)
    assert to_port(rsched) == sched
    for plan, rplan in ((None, None),
                        (RP.plan_reductions(p, sched, "lazy"),
                         RRP.plan_reductions(rp, rsched, "lazy"))):
        got = _render(L.lint(sched, plan=plan))
        assert got == _render(RL.lint(rsched, plan=rplan))
        assert not [f for f in got if f[1] == L.ERROR]


@pytest.mark.parametrize("name,variant", CASES, ids=IDS)
def test_overflow_proofs_match_reference(name, variant):
    p, rp = get_params(name), ref_get_params(name)
    sched, rsched = p.schedule(variant), rp.schedule(variant)
    for mode in ("eager", "lazy"):
        got = B.prove_overflow_safety(p, sched, reduction=mode)
        want = RB.prove_overflow_safety(rp, rsched, reduction=mode)
        assert got.proved and want.proved
        assert (got.schedule, got.q) == (want.schedule, want.q)
        assert _checks(got) == _checks(want)
        assert got.min_margin_bits == want.min_margin_bits


@pytest.mark.parametrize("name,variant", CASES, ids=IDS)
def test_depth_and_costs_match_reference(name, variant):
    p, rp = get_params(name), ref_get_params(name)
    d = B.depth_report(p, variant, measure=False)
    rd = RB.depth_report(rp, variant, measure=False)
    assert dataclasses.astuple(d) == dataclasses.astuple(rd) and d.ok
    # the measured depth against the reference's, as its snapshot holds it
    measured = B.depth_report(p, variant, device="cpu").measured
    assert measured == SNAPSHOT["presets"][name]["variants"][variant][
        "depth"]["measured"] == d.static
    assert C.analyze_cost(p, variant=variant).to_json() == \
        RC.analyze_cost(rp, variant=variant).to_json()
    assert C.reduction_report(p, variant=variant).to_json() == \
        RC.reduction_report(rp, variant=variant).to_json()


@pytest.mark.parametrize("build", [b for b, _ in BROKEN],
                         ids=[n for _, n in BROKEN])
def test_linter_diagnoses_broken_programs_like_the_reference(build):
    rbroken, code, _ = build()
    broken = to_port(rbroken)
    got = _render(L.lint(broken))
    assert got == _render(RL.lint(rbroken))
    assert code in {f[0] for f in got if f[1] == L.ERROR}
    assert code not in {f[0] for f in _render(L.lint(broken,
                                                     suppress=[code]))}


@pytest.mark.parametrize("build", [b for b, _ in BROKEN_PLANS],
                         ids=[n for _, n in BROKEN_PLANS])
def test_over_deferred_plans_fail_like_the_reference(build):
    rsched, rplan, code, _ = build()
    sched, plan = to_port(rsched), to_port(rplan)
    got = _render(L.lint(sched, plan=plan))
    assert got == _render(RL.lint(rsched, plan=rplan))
    assert code in {f[0] for f in got}
    p, rp = get_params("pasta-128s"), ref_get_params("pasta-128s")
    proof = B.prove_overflow_safety(p, sched, plan=plan)
    rproof = RB.prove_overflow_safety(rp, rsched, plan=rplan)
    assert not proof.proved and _checks(proof) == _checks(rproof)


def test_rule_catalog_matches_reference():
    assert [(r.code, r.name, r.severity, r.doc)
            for r in L.registered_rules()] == \
        [(r.code, r.name, r.severity, r.doc) for r in RL.registered_rules()]
    with pytest.raises(ValueError, match="unknown lint rule code"):
        L.lint(get_params("hera-128a").schedule(), suppress=["SA999"])


def test_machine_models_and_engine_profiles():
    cpu = C.MachineModel.for_backend("cpu")
    ref_cpu = RC.MachineModel.for_backend("cpu")
    assert (cpu.elem_ops_per_s, cpu.mem_bw, cpu.dispatch_s) == \
        (ref_cpu.elem_ops_per_s, ref_cpu.mem_bw, ref_cpu.dispatch_s)
    card = C.MachineModel.for_backend(torch.device("cuda", 0))
    assert (card.name, card.elem_ops_per_s, card.mem_bw) == \
        ("cuda", 16.7e12, 3.35e12)
    assert card.dispatch_s == C.CUDA_DISPATCH_S > 0
    assert sorted(C.ENGINE_PROFILES) == ["cuda", "ref"]
    p, rp = get_params("rubato-128l"), ref_get_params("rubato-128l")
    # the oracle's prediction on the CPU model is the reference's
    got = C.predict_engine_times(p, 64, machine=cpu)
    want = RC.predict_engine_times(rp, 64, engines=["ref"], machine=ref_cpu)
    assert list(got) == ["ref"]
    assert dataclasses.astuple(got["ref"]) == dataclasses.astuple(want["ref"])
    on_card = C.predict_engine_times(p, 64, machine=card)
    assert sorted(on_card) == ["cuda", "ref"]
    assert on_card["ref"].bound_by == "dispatch"
    assert on_card["cuda"].seconds < on_card["ref"].seconds


def test_measured_ordering_agreement_and_mismatch():
    p = get_params("hera-128a")
    card = C.MachineModel.for_backend("cuda")
    rows = [{"engine": "ref", "window": 256, "p50_ms": 40.0},
            {"engine": "ref", "window": 128, "p50_ms": 30.0},
            {"engine": "cuda", "window": 256, "p50_ms": 0.5}]
    ok = C.validate_measured_ordering(p, rows, machine=card)
    assert ok.ok and ok.measured_per_lane_ms["ref"] == 40.0 / 256
    swapped = [dict(r, engine={"ref": "cuda", "cuda": "ref"}[r["engine"]])
               for r in rows]
    bad = C.validate_measured_ordering(p, swapped, machine=card)
    assert not bad.ok and "MISMATCH" in bad.render()
    thin = C.validate_measured_ordering(p, rows[:1], machine=card)
    assert thin.skipped and "SKIPPED" in thin.render()


def test_cli_check_passes_against_the_reference_snapshot(capsys):
    assert cli.main(["--all", "--check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "snapshot check: 0 error(s), 0 warning(s); analytic matrix ok" \
        in out


def test_cli_check_flags_analytic_drift(tmp_path, capsys):
    snap = json.loads(json.dumps(SNAPSHOT))
    snap["presets"]["hera-128a"]["variants"]["normal"]["overflow"][
        "n_checks"] += 1
    path = tmp_path / "snap.json"
    path.write_text(json.dumps(snap))
    assert cli.main(["--all", "--check", "--no-measure", "--device", "cpu",
                     "--snapshot", str(path)]) == 1
    assert "overflow n_checks drifted" in capsys.readouterr().out


def test_cli_writes_only_an_explicit_snapshot_outside_benchmarks(tmp_path):
    with pytest.raises(SystemExit):
        cli.main(["--all", "--write-snapshot", "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(["--all", "--write-snapshot", "--device", "cpu",
                  "--snapshot", str(cli.BENCHMARKS / "x.json")])
    assert not (cli.BENCHMARKS / "x.json").exists()
    path = tmp_path / "port.json"
    assert cli.main(["--all", "--write-snapshot", "--no-measure",
                     "--device", "cpu", "--snapshot", str(path)]) == 0
    written = json.loads(path.read_text())
    assert written["package"] == "repro_torch" and written["backend"] == "cpu"
    assert sorted(written["presets"]["hera-80"]["predicted"]) == ["ref"]
    assert cli.main(["--all", "--check", "--no-measure", "--device", "cpu",
                     "--snapshot", str(path)]) == 0


def test_cli_single_preset_json(capsys):
    assert cli.main(["pasta-128l", "--format", "json", "--device",
                     "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["ok"] and [r["variant"] for r in out["results"]] == VARIANTS
    assert all(r["depth"]["measured"] == 4 for r in out["results"])
