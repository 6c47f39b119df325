"""`sampler_roofline` on made-up device operations."""

import pytest

from hhebench import cost, harness
from hhebench.tests.test_hhebench_trace import KIND, MS, _run
from hhebench.trace import DeviceOp, Trace

LANES = 140032


def _trace(ops):
    return Trace(ops, [("hhebench.window", 0, 10 * MS)], (0, 10 * MS), 1,
                 LANES)


def _read(trace, cell):
    return harness.reader("sampler_roofline")(_run(trace, cell))


@pytest.mark.parametrize("cell,words", [
    ("rubato-128l.bulk-vectors", 324 + 188 + 60),
    ("hera-128a.bulk-vectors", 112 + 96)])
def test_sampler_roofline_sums_both_kernels(cell, words):
    ops = [DeviceOp("void (anonymous namespace)::sampler_uniform_kernel"
                    "<int>(int const*, long*, int, int, int, int, unsigned "
                    "int, unsigned int)", 0, MS, 7),
           DeviceOp("aes_xof_kernel", MS, 3 * MS, 7),
           DeviceOp("void (anonymous namespace)::sampler_gauss_kernel<int>"
                    "(int const*, int const*, int, int, unsigned long "
                    "const*, int, int, long*, int, int)", 3 * MS,
                    3 * MS + MS // 2, 7)]
    if cell.startswith("hera"):
        ops.pop()                        # no noise: no Gaussian launch
    seconds = 1.5e-3 if cell.startswith("rubato") else 1e-3
    need = cost.least_seconds(4 * words * LANES, KIND)
    assert _read(_trace(ops), cell) == pytest.approx(100 * need / seconds)


def test_sampler_roofline_finds_nothing_without_the_kernels():
    cell = "rubato-128l.bulk-vectors"
    assert _read(None, cell) is None
    # the parent's trace: the plain samplers' PyTorch kernels only
    plain = [DeviceOp("aes_xof_kernel", 0, MS, 7),
             DeviceOp("at::native::tensor_kernel_scan_innermost_dim<long>",
                      MS, 3 * MS, 7),
             DeviceOp("keystream_kernel<64>", 3 * MS, 4 * MS, 3)]
    assert _read(_trace(plain), cell) is None
    assert _read(_trace([]), cell) is None
