"""Plain PyTorch version of the fused keystream kernel: the cipher itself.

Delegates to the same `build_schedule(params)` program the CUDA kernel
interprets (`core/schedule.py`), so the oracle and the kernel execute one
shared cipher description.
"""

from __future__ import annotations

from repro_torch.core.params import CipherParams
from repro_torch.core.redplan import DEFAULT_REDUCTION
from repro_torch.core.schedule import build_schedule, execute_schedule


def keystream_ref(params: CipherParams, key, rc, noise=None,
                  variant: str = "normal", mats=None,
                  reduction: str = DEFAULT_REDUCTION):
    """key: (n,) int64; rc: (lanes, n_round_constants) int64; noise:
    (lanes, l) signed ints or None; mats: (lanes, n_matrix_constants)
    int64 or None.  Returns (lanes, l) int64 keystream blocks."""
    sched = build_schedule(params, variant)
    return execute_schedule(params, sched, key, rc, noise, mats=mats,
                            reduction=reduction)
