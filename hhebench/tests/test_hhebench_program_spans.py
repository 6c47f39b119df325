"""The readers of the program's own spans (`repro_torch.obs`): each on
made-up device operations and span records, None where the program
recorded nothing or has no spans, and a tiny traced run on the CPU."""

import sys
from collections import Counter

import pytest

from hhebench import harness
from hhebench.tests.conftest import BULK_TINY
from hhebench.trace import DeviceOp, Trace

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402

READERS = ("producer.xof_ms_per_window", "producer.uniform_ms_per_window",
           "producer.gauss_ms_per_window", "producer.idle_ms_per_window",
           "farm.host_ms_per_window", "cipher.table_restacks_per_window")
MS = 1_000_000      # ns


@pytest.fixture(autouse=True)
def _fresh():
    obs.clear()
    yield
    obs.clear()


def _run(ops, window=(0, 100 * MS), units=2):
    trace = Trace(ops, [], window, units, units * 10)
    outcome = harness.Outcome(1.0, {}, units, 0, {}, 0, trace)
    return harness.Run(None, outcome, "made-up")


def _rec(name, start, end, parent=None, device_ms=None):
    r = obs.Record(name, start * MS, end * MS, parent=parent)
    r._device_ms = device_ms
    return r


def _two_windows():
    """Two windows' spans (ms): produce 0-30 and 50-70, consume, encrypt;
    the first window re-stacks its tables (2-12); one span lies outside
    the traced stretch."""
    recs = []
    for base, tables in ((0, True), (50, False)):
        prod = _rec("farm.produce", base, base + 20 + 10 * tables)
        recs.append(prod)
        if tables:
            recs.append(_rec("cipher.tables", base + 2, base + 12, prod))
        at = base + 12 if tables else base + 2
        recs += [_rec("producer.upload", at, at + 1, prod),
                 _rec("producer.xof", at + 1, at + 3, prod, 1.5),
                 _rec("producer.uniform", at + 3, at + 6, prod, 3.0),
                 _rec("producer.gauss", at + 6, at + 8, prod, 4.5),
                 _rec("farm.consume", base + 35 - 5 * (not tables),
                      base + 37 - 5 * (not tables)),
                 _rec("farm.encrypt", base + 40, base + 41)]
    recs.append(_rec("farm.produce", 150, 160))     # after the stretch
    return recs


# device busy 0-4 and 20-100 ms: idle 4-20 ms, its midpoint (12) inside
# the first window's farm.produce
OPS = [DeviceOp("aes_xof_kernel", 0, 4 * MS, 7),
       DeviceOp("keystream_kernel", 20 * MS, 100 * MS, 8)]
WANT = {"producer.xof_ms_per_window": 1.5,
        "producer.uniform_ms_per_window": 3.0,
        "producer.gauss_ms_per_window": 4.5,
        "producer.idle_ms_per_window": 8.0,
        # produce 30 + 20, consume 2 + 2, encrypt 1 + 1, over 2 windows
        "farm.host_ms_per_window": 28.0,
        "cipher.table_restacks_per_window": 0.5}


@pytest.mark.parametrize("name", READERS)
def test_reader_on_made_up_spans(monkeypatch, name):
    monkeypatch.setattr(obs, "records", _two_windows)
    assert harness.reader(name)(_run(OPS)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_without_records(monkeypatch, name):
    read = harness.reader(name)
    assert read(_run(OPS)) is None                  # nothing recorded
    monkeypatch.setattr(obs, "records", _two_windows)
    assert read(_run(OPS, window=(200 * MS, 300 * MS))) is None
    outcome = harness.Outcome(1.0, {}, 1, 0, {}, 0, None)
    assert read(harness.Run(None, outcome, "made-up")) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_of_a_program_without_spans(monkeypatch, name):
    """The parent program has no `repro_torch.obs`: the reader gives
    None, and does not raise."""
    import repro_torch

    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert harness.reader(name)(_run(OPS)) is None


def test_idle_outside_the_producer_is_not_counted(monkeypatch):
    """A gap whose midpoint lies in farm.consume, or in no span, is not
    the producer's."""
    ops = [DeviceOp("k", 0, 33 * MS, 7), DeviceOp("k", 39 * MS, 44 * MS, 7),
           DeviceOp("k", 46 * MS, 100 * MS, 7)]
    monkeypatch.setattr(obs, "records", _two_windows)
    assert harness.reader("producer.idle_ms_per_window")(_run(ops)) == 0.0


def test_tiny_run_records_only_the_traced_stretch(tiny):
    line = tiny("rubato-128l.bulk-vectors")
    assert line["correct"] and obs.records() == []
    line = tiny("rubato-128l.bulk-vectors", trace=True)
    assert line["correct"]
    names = Counter(r.name for r in obs.records())
    for name in ("farm.produce", "farm.consume", "farm.encrypt",
                 "producer.xof"):
        assert names[name] == BULK_TINY["trace_jobs"], name
    m = line["metrics"]
    assert m["farm.host_ms_per_window"]["value"] > 0
    assert m["cipher.table_restacks_per_window"]["value"] == 0.0
    # no device timeline on the CPU: no device spans, no idle to place
    for name in READERS[:4]:
        assert name not in m
