"""The bulk loop on the card at a small size: correct, and every
per-layer metric of a traced bulk run read and under 100%.  Run on a
machine with the card: ``python -m pytest -q -m gpu hhebench/tests``."""

import pytest

from hhebench import harness
from hhebench.tests.conftest import BULK_TINY, bench_with_every_pair


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["hera-128a.bulk-vectors",
                                  "rubato-128l.bulk-vectors"])
def test_bulk_on_the_card(card, cell):
    line = harness.run_cell(cell, 11, 1.0, True, card,
                            traffic_overrides={**BULK_TINY, "clients": 64},
                            bench=bench_with_every_pair())
    assert line["correct"], line["checks"]
    m = line["metrics"]
    for name in ("keystream_roofline", "aes_xof_roofline"):
        assert 0 < m[name]["value"] < 100
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]


@pytest.mark.gpu
def test_control_fails_on_the_card(card):
    line = harness.run_cell("rubato-128l.bulk-vectors", 11, 0.5, False, card,
                            "bf16", traffic_overrides=BULK_TINY)
    assert not line["correct"]
