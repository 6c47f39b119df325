"""Carry reference state across to the port.

:func:`batch_from_reference` rebuilds a port :class:`CipherBatch` from the
state that defines a reference `repro.core.cipher.CipherBatch`: the cipher
key and each session's 16-byte nonce, in session order.  The two pools
then compute the same keystream for the same (session, counter) lanes.
Only numpy arrays cross, so nothing here imports the reference.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.cipher import CipherBatch


def batch_from_reference(params_name: str, key_np, nonces_np, *,
                         device=None, engine="ref") -> CipherBatch:
    """key_np: (n,) uint32 key; nonces_np: (sessions, 16) uint8 nonces,
    e.g. ``np.asarray(ref_batch.key)`` and
    ``np.stack([s.nonce for s in ref_batch.sessions])``."""
    key = np.asarray(key_np).astype(np.int64).reshape(-1)
    batch = CipherBatch(params_name, key=key, engine=engine, device=device)
    for nonce in np.asarray(nonces_np, np.uint8).reshape(-1, 16):
        batch.add_session(nonce)
    return batch
