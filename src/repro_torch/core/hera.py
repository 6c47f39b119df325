"""HERA stream-key generation (paper §III-A).

    HERA(k) = Fin ∘ RF_{r-1} ∘ ... ∘ RF_1 ∘ ARK(k)       applied to ic
    RF  = ARK ∘ Cube ∘ MixRows ∘ MixColumns
    Fin = ARK ∘ MixRows ∘ MixColumns ∘ Cube ∘ MixRows ∘ MixColumns

The port's copy of `repro.core.hera`: a thin wrapper over the plain
PyTorch interpreter `execute_schedule` of the program `build_schedule`
emits, the same program the fused CUDA kernel runs.
"""

from __future__ import annotations

from repro_torch.core.params import CipherParams
from repro_torch.core.schedule import build_schedule, execute_schedule


def hera_stream_key(params: CipherParams, key, rc, ic=None,
                    variant: str = "normal"):
    """Generate keystream blocks.

    key: (..., n) int64 in Z_q (broadcastable against rc's batch dims).
    rc:  (..., r+1, n) int64 round constants (the producer's output).
    Returns (..., n) int64 keystream blocks on rc's device.
    """
    if rc.shape[-2] != params.n_arks or rc.shape[-1] != params.n:
        raise ValueError(f"rc shape {rc.shape} != (..., {params.n_arks}, {params.n})")
    sched = build_schedule(params, variant)
    flat = rc.reshape(rc.shape[:-2] + (sched.n_round_constants,))
    return execute_schedule(params, sched, key, flat, ic=ic)
