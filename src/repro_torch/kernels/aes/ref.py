"""Plain PyTorch versions of the AES kernel's two entry points."""

from __future__ import annotations

import torch

from repro_torch.crypto import aes as aes_mod
from repro_torch.crypto.xof import aes_xof_words_batched


def aes_ctr_ref(round_keys, nonce12, counters):
    """round_keys: (11, 16) bytes; nonce12: (12,) bytes; counters: (lanes,)
    integer counters in [0, 2^32).  Returns (lanes, 16) uint8 blocks of
    AES(nonce12 || be32(counter)), on counters' device."""
    counters = counters.to(torch.int64) & 0xFFFFFFFF
    dev = counters.device
    lanes = counters.shape[0]
    ctr_bytes = torch.stack(
        [(counters >> 24) & 0xFF, (counters >> 16) & 0xFF,
         (counters >> 8) & 0xFF, counters & 0xFF], dim=-1).to(torch.int32)
    prefix = torch.as_tensor(nonce12, device=dev).to(torch.int32)
    blocks = torch.cat([prefix.expand(lanes, 12), ctr_bytes], dim=-1)
    rk = torch.as_tensor(round_keys, device=dev)
    return aes_mod.aes128_encrypt_blocks(blocks, rk).to(torch.uint8)


def aes_xof_ref(rk_table, n12_table, session_ids, block_ctrs, n_words: int):
    """rk_table: (S, 11, 16) bytes; n12_table: (S, 12) bytes; session_ids,
    block_ctrs: (lanes,).  Returns (lanes, n_words) int32 word bit
    patterns of each lane's session XOF at its counter."""
    sid = session_ids.to(torch.int64)
    return aes_xof_words_batched(rk_table[sid], n12_table[sid], block_ctrs,
                                 n_words)
