"""Plain PyTorch version of the MRMC kernel (the core round primitive)."""

from __future__ import annotations

from repro_torch.core import rounds as R
from repro_torch.core.params import CipherParams


def mrmc_ref(params: CipherParams, x):
    """x: (lanes, n) int64 row-major states -> (lanes, n) M·X·Mᵀ per
    branch."""
    return R.mrmc(params, x)
