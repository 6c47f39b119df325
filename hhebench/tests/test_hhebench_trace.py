"""The reduction from a trace to the per-layer metrics, on made-up
device operations and host spans."""

import pytest

from hhebench import cost, harness
from hhebench.tests.conftest import bench_with_every_pair
from hhebench.trace import DeviceOp, Trace, merge, overlap

KIND = "NVIDIA H100 80GB HBM3"
MS = 1_000_000          # ns


def _run(trace, cell="hera-128a.bulk-vectors", host=None):
    _, cfg, tr = harness.resolve(bench_with_every_pair(), cell)
    c = harness.Cell(cell, cfg, tr, 1, 1.0, True, None)
    out = harness.Outcome(1.0, host or {}, 1, 0, {}, 0, trace)
    return harness.Run(c, out, KIND)


def _trace(lanes=524288):
    ops = [DeviceOp("aes_xof_kernel", 0, 2 * MS, 7),
           DeviceOp("at::native::scan", 2 * MS, 6 * MS, 7),
           DeviceOp("keystream_kernel<16>", 5 * MS, 6 * MS, 3),
           DeviceOp("Memcpy HtoD", 8 * MS, 9 * MS, 7)]
    spans = [("hhebench.window", 0, 10 * MS), ("hhebench.plan", 6 * MS,
                                               9 * MS)]
    return Trace(ops, spans, (0, 10 * MS), 1, lanes, inside="farm")


def test_intervals():
    assert merge([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert overlap([(0, 3), (5, 8)], [(2, 6)]) == 2


def _read(name, run):
    return harness.reader(name)(run)


def test_kernel_rooflines():
    run = _run(_trace())
    need = cost.least_seconds(448 * 524288, KIND)
    assert _read("keystream_roofline", run) == pytest.approx(
        100 * need / 1e-3)
    need = cost.least_seconds(456 * 524288, KIND)
    assert _read("aes_xof_roofline", run) == pytest.approx(100 * need / 2e-3)


def test_stream_metrics():
    run = _run(_trace())
    assert _read("producer.device_ms_per_window", run) == pytest.approx(7.0)
    # both streams busy 5-6 ms; the consumer's 1 ms is the lesser
    assert _read("farm.overlap_share", run) == pytest.approx(100.0)
    assert _read("device.idle_share", run) == pytest.approx(30.0)


def test_idle_gaps_by_host_span():
    gaps = dict(_trace().idle_gaps())
    assert gaps == pytest.approx({"hhebench.plan": 2e-3, "farm": 1e-3})


def test_readers_find_nothing_without_a_trace():
    run = _run(None)
    for name in ("keystream_roofline", "aes_xof_roofline",
                 "producer.device_ms_per_window", "farm.overlap_share",
                 "device.idle_share"):
        assert _read(name, run) is None
    empty = _run(Trace([], [], (0, MS), 1, 1))
    assert _read("keystream_roofline", empty) is None
    assert _read("farm.overlap_share", empty) is None


def test_job_tail_reads_the_window_host_clock():
    assert _read("farm.job_p95_ms", _run(None, host={"job_p95_ms": 31.5})) \
        == 31.5
    assert _read("farm.job_p95_ms", _run(None)) is None
