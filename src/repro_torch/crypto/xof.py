"""Extendable-output functions (XOF) for constant sampling.

The port's copy of `repro.crypto.xof`.  Two streams:

  * ``aes`` — AES-128-CTR keyed by the public nonce (the paper's
    conformance stream).  The XOF for block counter ``ctr`` under nonce
    ``nc`` (16 bytes) is

        AES-CTR(key = nc, counter block = nc[0:12] || be32(ctr·2^16 + i))

    so each cipher-block counter owns a 2^16-block counter subspace.
    Output blocks are packed into little-endian 32-bit words.
  * ``threefry`` — JAX's counter-based threefry2x32 PRF, reproduced here
    bit for bit from JAX 0.9.0 (``jax/_src/prng.py``): a lane's key is
    ``fold_in(root, ctr)`` and its words are ``random.bits(key, (n,),
    uint32)`` with ``jax_threefry_partitionable`` on, i.e. word i is
    ``bits1 ^ bits2`` of threefry2x32(key; hi = 0, lo = i).

AES words travel as int32 tensors holding the uint32 bit patterns, the
type the CUDA AES kernel writes and the sampler kernels read
(`kernels.build.from_u32_bits` widens them); the producer runs the kernel through
`repro_torch.kernels.aes.ops.aes_xof_words`, and the functions here are
its plain PyTorch version.  Threefry words are int64 tensors of the
uint32 values.  The reference computes threefry in XLA, outside any Pallas
kernel, so its port is plain PyTorch on whatever device it is given: int64
arithmetic masked to 32 bits (the CPU's uint32 has no add or shift),
updated in place so a window's peak stays three planes deep.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.crypto import aes as aes_mod
from repro_torch.device import resolve_device

_CTR_SPACE = 1 << 16  # AES blocks reserved per (nonce, cipher-block) pair
_M32 = 0xFFFFFFFF


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
    base = (ctrs.to(torch.int64) * _CTR_SPACE) & _M32
    idx = (base[:, None] + torch.arange(n_blocks, device=dev)) & _M32
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


def _lane_ctrs(block_ctrs, device) -> torch.Tensor:
    """(lanes,) int64 counters on ``device``, wrapped to uint32 as the
    reference's ``jnp.asarray(ctrs, uint32)`` wraps them."""
    if torch.is_tensor(block_ctrs):
        ctr = block_ctrs.to(device=device, dtype=torch.int64)
    else:
        ctr = torch.as_tensor(np.asarray(block_ctrs).astype(np.int64),
                              device=device)
    return ctr.reshape(-1) & _M32


def aes_xof_words(nonce, block_ctrs, n_words: int, device=None):
    """Single-stream AES XOF: one nonce, (lanes,) counters -> (lanes,
    n_words) int64 word values, plain PyTorch on ``device`` (None = the
    card)."""
    dev = resolve_device(device)
    nonce = np.asarray(nonce, dtype=np.uint8).reshape(16)
    ctr = _lane_ctrs(block_ctrs, dev)
    lanes = ctr.shape[0]
    rk = torch.as_tensor(aes_mod.aes128_key_expand(nonce), device=dev)
    n12 = torch.as_tensor(nonce[:12].copy(), device=dev)
    words = aes_xof_words_batched(rk.expand(lanes, 11, 16),
                                  n12.expand(lanes, 12), ctr, n_words)
    return words.to(torch.int64) & _M32


# --------------------------------------------------------------------------
# threefry2x32 (JAX 0.9.0, jax/_src/prng.py)
# --------------------------------------------------------------------------
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KEY_PARITY = 0x1BD11BDA


def _rotl32_(x, r: int, tmp) -> None:
    """x <- rotl32(x, r) in place; x holds values in [0, 2^32)."""
    torch.bitwise_right_shift(x, 32 - r, out=tmp)
    x.bitwise_left_shift_(r).bitwise_and_(_M32).bitwise_or_(tmp)


def threefry2x32_(k1, k2, x0, x1):
    """The threefry2x32 hash (``_threefry2x32_lowering``, unrolled) of
    the count pairs (x0, x1) under the key (k1, k2), in place.

    x0, x1: int64 tensors of one shape holding uint32 values, overwritten
    with the two output words; k1, k2: int64 tensors (or ints) that
    broadcast against them.  20 rounds with rotations (13, 15, 26, 6) /
    (17, 29, 16, 24), a key injection after every 4, key parity
    0x1BD11BDA.  Returns (x0, x1)."""
    ks = (k1, k2, (k1 ^ k2 ^ _KEY_PARITY) & _M32)
    x0.add_(ks[0]).bitwise_and_(_M32)
    x1.add_(ks[1]).bitwise_and_(_M32)
    tmp = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            _rotl32_(x1, r, tmp)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(_M32)
    return x0, x1


def threefry_root_key(nonce) -> np.ndarray:
    """Root PRF key for a nonce (host-side, once per session): the uint32
    key data of the reference's ``jax.random.key(seed)``.

    The reference seeds with the 63-bit little-endian integer of nonce
    bytes 0-7; with x64 off only its low 32 bits survive, so the key is
    ``[0, low32(nonce[0:4])]`` and the stream depends on nonce bytes 0-3
    only.  That is a property of the reference, reproduced bit for bit."""
    nonce = np.asarray(nonce, dtype=np.uint8).reshape(16)
    seed = int.from_bytes(nonce.tobytes()[:8], "little") & 0x7FFFFFFFFFFFFFFF
    return np.array([0, seed & _M32], dtype=np.uint32)


def threefry_xof_words_batched(root_keys, block_ctrs, n_words: int):
    """Multi-stream threefry XOF: per-lane root keys.

    root_keys: (lanes, 2) int64 tensor of :func:`threefry_root_key` data;
    block_ctrs: (lanes,) counters.  Returns (lanes, n_words) int64 word
    values on root_keys' device, each lane equal to
    :func:`threefry_xof_words` under its own nonce."""
    dev = root_keys.device
    roots = root_keys.to(torch.int64).reshape(-1, 2)
    ctr = _lane_ctrs(block_ctrs, dev)
    if ctr.shape[0] != roots.shape[0]:
        raise ValueError("root_keys / block_ctrs length mismatch")
    # fold_in(root, ctr) = threefry2x32(root; threefry_seed(ctr) = (0, ctr))
    k1, k2 = threefry2x32_(roots[:, 0], roots[:, 1],
                           torch.zeros_like(ctr), ctr.clone())
    lanes = ctr.shape[0]
    # bits(key, (n,)): counts (hi, lo) = (0, i); word = bits1 ^ bits2
    x0 = torch.zeros((lanes, n_words), dtype=torch.int64, device=dev)
    x1 = torch.arange(n_words, dtype=torch.int64,
                      device=dev).expand(lanes, n_words).clone()
    y0, y1 = threefry2x32_(k1[:, None], k2[:, None], x0, x1)
    return y0.bitwise_xor_(y1)


def threefry_xof_words(nonce, block_ctrs, n_words: int, device=None):
    """Single-stream threefry XOF: one nonce, (lanes,) counters ->
    (lanes, n_words) int64 word values on ``device`` (None = the card)."""
    dev = resolve_device(device)
    ctr = _lane_ctrs(block_ctrs, dev)
    root = torch.as_tensor(threefry_root_key(nonce).astype(np.int64),
                           device=dev)
    return threefry_xof_words_batched(root.expand(ctr.shape[0], 2), ctr,
                                      n_words)


_BACKENDS = {"aes": aes_xof_words, "threefry": threefry_xof_words}


def make_xof(kind: str):
    """The single-stream word function of one XOF stream (a primitive
    accessor for direct XOF tests; producers select streams through
    `repro_torch.core.producer`)."""
    if kind not in _BACKENDS:
        raise ValueError(f"unknown XOF backend {kind!r}; have {list(_BACKENDS)}")
    return _BACKENDS[kind]


def xof_words(kind: str, nonce, block_ctrs, n_words: int, device=None):
    return make_xof(kind)(nonce, block_ctrs, n_words, device=device)
