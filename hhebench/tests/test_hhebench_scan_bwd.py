"""`ssm.scan_bwd_ms_per_step` on made-up span records."""

from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from hhebench import harness  # noqa: E402
from hhebench.trace import DeviceOp, Trace  # noqa: E402
from repro_torch import obs  # noqa: E402


def test_the_scan_backward_reader_reads_its_spans():
    """``ssm.scan_bwd_ms_per_step`` reads the ``ssm.scan_bwd`` spans (the
    scan's backward, opened on autograd's thread) by their stream events,
    not by the host span's overlap with the stream: the kernels run after
    the host has left the span.  A span past the traced window, or one
    without events (off the card), does not count; a program without such
    spans gives None."""
    read = harness.reader("ssm.scan_bwd_ms_per_step")
    # the backward's kernels (stream 7) run after the host span (200..260)
    ops = [DeviceOp("dx_kernel", 300, 700, 7), DeviceOp("aes", 150, 300, 9)]
    run = SimpleNamespace(trace=Trace(ops, [], (0, 2000), 3, 0))

    def rec(name, start, end, device_ms):
        r = obs.Record(name, start, end)
        r._device_ms = device_ms
        return r

    obs.clear()
    obs._records.extend([rec("ssm.scan", 90, 120, 5.0),
                         rec("ssm.scan_bwd", 200, 260, 2.5),
                         rec("ssm.scan_bwd", 800, 900, 4.0),
                         rec("ssm.scan_bwd", 1000, 1100, None),
                         rec("ssm.scan_bwd", 1900, 2100, 9.0)])
    assert read(run) == pytest.approx((2.5 + 4.0) / 3)
    obs.clear()
    obs._records.extend([rec("ssm.scan", 90, 120, 5.0),
                         rec("ssm.scan_bwd", 200, 260, None)])
    assert read(run) is None
    obs.clear()
    obs._records.append(rec("ssm.scan", 90, 120, 5.0))
    assert read(run) is None
    assert read(SimpleNamespace(trace=None)) is None
    obs.clear()
