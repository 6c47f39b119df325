"""Rubato stream-key generation (paper §III-B).

    Rubato(k) = AGN ∘ Fin ∘ RF_{r-1} ∘ ... ∘ RF_1 ∘ ARK(k)   applied to ic
    RF  = ARK ∘ Feistel ∘ MixRows ∘ MixColumns
    Fin = Tr ∘ ARK ∘ MixRows ∘ MixColumns ∘ Feistel ∘ MixRows ∘ MixColumns

The port's copy of `repro.core.rubato`: a thin wrapper over the plain
PyTorch interpreter `execute_schedule` of the program `build_schedule`
emits, the same program the fused CUDA kernel runs.
"""

from __future__ import annotations

from repro_torch.core.params import CipherParams
from repro_torch.core.schedule import build_schedule, execute_schedule


def rubato_stream_key(params: CipherParams, key, rc, noise_signed, ic=None,
                      variant: str = "normal"):
    """Generate keystream blocks.

    key: (..., n) int64 in Z_q.
    rc:  (..., r*n + l) flat int64 round constants (the producer's output).
    noise_signed: (..., l) signed discrete-Gaussian samples (AGN), or None.
    Returns (..., l) int64 keystream blocks on rc's device.
    """
    if rc.shape[-1] != params.n_round_constants:
        raise ValueError(
            f"rc last dim {rc.shape[-1]} != {params.n_round_constants}"
        )
    sched = build_schedule(params, variant)
    return execute_schedule(params, sched, key, rc, noise_signed, ic=ic)
