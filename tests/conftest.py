"""Shared test fixtures.  NOTE: no XLA_FLAGS here by design — smoke tests
and benches must see 1 device (the 512-device override belongs ONLY to
launch/dryrun.py and launch/roofline.py)."""

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running (full-lane interpret-mode Pallas sweeps); "
        "excluded from the fast CI lap (scripts/ci.sh)",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the PyTorch port's kernels); skipped "
        "without one",
    )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
