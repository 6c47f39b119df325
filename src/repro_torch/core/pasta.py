"""PASTA stream-key generation (Dobraunig et al., the third HHE cipher).

    PASTA(k) = Tr_t ∘ A_r ∘ S_{r-1} ∘ A_{r-1} ∘ ... ∘ S_0 ∘ A_0   applied to k
    A_i = branch-mix ∘ (+rc_i) ∘ per-branch matrix      (the affine layer)
    S_i = Feistel for i < r-1, Cube for the final round

The port's copy of `repro.core.pasta`: the key is the initial state, and
every per-block random word (the affine constants and the dense matrix
planes) is an input.  A thin wrapper over the plain PyTorch interpreter
`execute_schedule` of the program `build_schedule` emits, the same
program the fused CUDA kernel runs.
"""

from __future__ import annotations

from repro_torch.core.params import CipherParams
from repro_torch.core.schedule import build_schedule, execute_schedule


def pasta_stream_key(params: CipherParams, key, rc, mats=None,
                     variant: str = "normal"):
    """Generate keystream blocks.

    key: (..., n) int64 in Z_q, the two-branch initial state (n = 2t).
    rc:  (..., (r+1)·n) flat int64 affine constants.
    mats: (..., (r+1)·n·t) flat int64 dense matrix planes.
    Returns (..., l) int64 keystream blocks (l = t, the first branch).
    """
    if rc.shape[-1] != params.n_round_constants:
        raise ValueError(
            f"rc last dim {rc.shape[-1]} != {params.n_round_constants}"
        )
    sched = build_schedule(params, variant)
    return execute_schedule(params, sched, key, rc, mats=mats)
