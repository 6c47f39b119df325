"""AES-128-CTR extendable-output function (XOF) for constant sampling.

The port's copy of the AES half of `repro.crypto.xof`.  The XOF for block
counter ``ctr`` under public nonce ``nc`` (16 bytes) is

    AES-CTR(key = nc, counter block = nc[0:12] || be32(ctr·2^16 + i))

so each cipher-block counter owns a 2^16-block counter subspace.  Output
blocks are packed into little-endian 32-bit words.

Words travel as int32 tensors holding the uint32 bit patterns, the same
type the CUDA AES kernel writes; `kernels.build.from_u32_bits` widens them
to int64 values for the samplers.  The functions here are the plain
PyTorch versions; the producer runs the kernel through
`repro_torch.kernels.aes.ops.aes_xof_words`.
"""

from __future__ import annotations

import torch

from repro_torch.crypto import aes as aes_mod

_CTR_SPACE = 1 << 16  # AES blocks reserved per (nonce, cipher-block) pair


def _words_from_blocks(blocks):
    """(..., nb, 16) bytes -> (..., nb*4) int32 words, little-endian
    within each word (bit patterns of the uint32 words)."""
    b = blocks.to(torch.int64).reshape(blocks.shape[:-1] + (4, 4))
    w = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    w = torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)
    return w.reshape(blocks.shape[:-2] + (-1,))


def _aes_ctr_blocks(nonce12, ctrs, n_blocks: int):
    """Counter blocks nonce12 || be32(ctr·2^16 + i): (lanes, n_blocks, 16).

    nonce12: (lanes, 12) bytes; ctrs: (lanes,) integer counters."""
    dev = ctrs.device
    base = (ctrs.to(torch.int64) * _CTR_SPACE) & 0xFFFFFFFF
    idx = (base[:, None] + torch.arange(n_blocks, device=dev)) & 0xFFFFFFFF
    ctr_bytes = torch.stack(
        [(idx >> 24) & 0xFF, (idx >> 16) & 0xFF, (idx >> 8) & 0xFF,
         idx & 0xFF], dim=-1).to(torch.int32)             # (lanes, nb, 4)
    prefix = nonce12.to(torch.int32)[:, None, :].expand(-1, n_blocks, 12)
    return torch.cat([prefix, ctr_bytes], dim=-1)


def aes_xof_words_batched(round_keys, nonce12, block_ctrs, n_words: int):
    """Multi-stream AES XOF, plain PyTorch.

    round_keys: (lanes, 11, 16) bytes, ``aes128_key_expand(nonce)`` per
    lane; nonce12: (lanes, 12) bytes; block_ctrs: (lanes,) counters.
    Returns (lanes, n_words) int32 word bit patterns, on block_ctrs' device.
    """
    n_blocks = (n_words + 3) // 4
    blocks = _aes_ctr_blocks(nonce12, block_ctrs, n_blocks)
    ks = aes_mod.aes128_encrypt_blocks(blocks, round_keys[:, None])
    return _words_from_blocks(ks)[:, :n_words]

