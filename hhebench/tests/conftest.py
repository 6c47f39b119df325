"""Shared pieces of the benchmark's CPU tests: tiny traffic that keeps a
run to a second or two here."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skipped without one")


BULK_TINY = dict(clients=4, slots=16 * 24, check_jobs=2, check_jobs_from=3,
                 warm_jobs=2, trace_jobs=2, check_lanes_per_job=8)


def bench_with_every_pair():
    """BENCHMARK.json with a cell for every (configuration, traffic)
    pair of the benchmark's files, so the tests also drive pairs no cell
    names yet."""
    from hhebench import harness

    bench = harness.load_benchmark()
    named = {c["name"] for c in bench["configs"]}
    bench["configs"] += [
        {"name": p.stem, "file": str(p.relative_to(harness.ROOT)),
         "source": "", "reduced": [], "why": "test"}
        for p in sorted((harness.HERE / "configs").glob("*.json"))
        if p.stem not in named]
    traffic_of = {w["name"]: w["traffic"] for w in bench["workloads"]}
    traffic = sorted(p.stem for p in (harness.HERE / "traffic").glob("*.json"))
    bench["workloads"] = [
        {"name": f"{c['name']}.{t}", "config": c["name"], "traffic": t,
         "chips": 1, "why": "test"} for c in bench["configs"] for t in traffic]
    # a metric read in some cells is read in every pair of their traffic
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kinds = {traffic_of[w] for w in m["workloads"]}
            m["workloads"] = [w["name"] for w in bench["workloads"]
                              if w["traffic"] in kinds]
    return bench


@pytest.fixture
def tiny():
    """run(workload, seed, **kw) -> the result line of a short CPU run."""
    from hhebench import harness

    bench = bench_with_every_pair()

    def run(workload, seed=5, seconds=0.4, trace=False, control=None,
            **over):
        return harness.run_cell(workload, seed, seconds, trace, "cpu",
                                control, traffic_overrides={**BULK_TINY, **over},
                                bench=bench)

    return run
