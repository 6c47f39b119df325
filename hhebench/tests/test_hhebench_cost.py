"""The yardstick's arithmetic and the benchmark's data: least bytes of
the kernels from the ciphers' parameters, the traffic's counts, and the
shape of BENCHMARK.json."""

import json
import math
import re

import numpy as np
import pytest

from hhebench import cost, harness
from hhebench.tests.conftest import bench_with_every_pair

BENCH = harness.load_benchmark()
PAIRS = bench_with_every_pair()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _cell(name):
    return harness.resolve(PAIRS, name)


@pytest.mark.parametrize("name,keystream,xof", [
    ("hera-128a.bulk-vectors", 448, 456),
    ("rubato-128l.bulk-vectors", 1232, 1304),
])
def test_least_bytes_a_lane(name, keystream, xof):
    cfg = _cell(name)[1]
    assert cost.keystream_bytes_per_lane(cfg) == keystream
    assert cost.xof_bytes_per_lane(cfg) == xof


def test_least_time_at_the_data_sheet_rate():
    t = cost.least_seconds(3.35e12, "NVIDIA H100 80GB HBM3")
    assert t == pytest.approx(1.0)
    with pytest.raises(KeyError):
        cost.least_seconds(1.0, "cpu")


@pytest.mark.parametrize("name,lanes,words", [
    ("hera-128a.bulk-vectors", 524288, 8388608),
    ("rubato-128l.bulk-vectors", 140032, 8401920),
])
def test_bulk_job_size(name, lanes, words):
    _, cfg, tr = _cell(name)
    blocks = math.ceil(tr["slots"] / cfg["l"])
    assert tr["clients"] * blocks == lanes
    assert lanes * cfg["l"] == words


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert c["file"].startswith("hhebench/") and len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").exists()
        e2e = [m for m in BENCH["end_to_end"] if harness.applies(m, w["name"])]
        assert {"setup_s", "keystream_words_per_s"} <= {m["name"] for m in e2e}
        assert any(harness.applies(m, w["name"]) for m in BENCH["per_layer"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and len(m["layer"]) <= 200
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
        for w in m["workloads"]:
            assert any(harness.applies(e, w) for e in BENCH["end_to_end"]
                       if e["name"] == m["moves"])
