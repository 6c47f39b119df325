"""HHE-encrypted data plane — the paper's cipher as a framework feature.

The port's copy of `repro.data.encrypted`.  The client encrypts token
batches with the symmetric cipher and ships ciphertext; the device that
holds the key regenerates the keystream and decrypts by modular
subtraction, so the host and network path never carry plaintext.  Token
ids are Z_q elements directly (vocab < q), so encryption is exact.

`EncryptedSource` wraps any source with ``.batch``, ``.seq_len`` and
``.batch_at(step)`` returning ``{"tokens": (B, T) numpy ints}``;
`make_decryptor` returns the decryption function a consumer applies on
the device.  `FarmEncryptedSource` draws its keystream from a
`CipherBatch` session through the `KeystreamFarm` FIFO, so `stream()`
dispatches step t+1's producer before step t's keystream is consumed.

Batch step t owns block counters [t·bpb, (t+1)·bpb), bpb = ceil(B·T/l):
counters never repeat across steps, and decryption needs only (key,
nonce, t).  Ciphertext is an int64 (B, T) tensor on the cipher's device
and ``base_ctr`` an int64 0-d tensor.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.cipher import Cipher, CipherBatch, StreamSession
from repro_torch.core.farm import KeystreamFarm, WindowPlan


def _blocks_for(n_tokens: int, l: int) -> int:
    return (n_tokens + l - 1) // l


def _token_tensor(tokens, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(tokens).reshape(-1).astype(np.int64),
                           device=device)


def _encrypted(mod, tokens, z, base_ctr: int) -> dict:
    """(B, T) tokens + the first B·T keystream words -> the batch dict."""
    B, T = np.shape(tokens)
    zf = z.reshape(-1)[: B * T]
    ct = mod.add(_token_tensor(tokens, zf.device), zf).reshape(B, T)
    return {"ct": ct, "base_ctr": torch.tensor(base_ctr, dtype=torch.int64,
                                                device=zf.device)}


def encrypt_tokens(cipher: Cipher, tokens: np.ndarray, base_ctr: int) -> dict:
    """tokens: (B, T) ints < q.  Returns dict(ct=(B, T) int64 tensor,
    base_ctr=0-d int64 tensor) on the cipher's device."""
    B, T = tokens.shape
    nblk = _blocks_for(B * T, cipher.params.l)
    z = cipher.keystream(np.arange(base_ctr, base_ctr + nblk, dtype=np.int64))
    return _encrypted(cipher.params.mod, tokens, z, base_ctr)


def make_decryptor(cipher: Cipher, labels_from_tokens: bool = True):
    """Returns fn(batch) -> plaintext batch, on the cipher's device.

    batch: {"ct": (B, T) ints, "base_ctr": scalar} ->
           {"tokens": (B, T) int32, "labels": (B, T) int32}
    """
    p = cipher.params

    def decrypt(batch):
        ct = batch["ct"]
        B, T = ct.shape
        n_tok = B * T
        nblk = _blocks_for(n_tok, p.l)
        base = int(batch["base_ctr"])
        z = cipher.keystream(np.arange(base, base + nblk, dtype=np.int64))
        ct = torch.as_tensor(ct, device=z.device).to(torch.int64)
        toks = p.mod.sub(ct.reshape(-1), z.reshape(-1)[:n_tok]) \
            .to(torch.int32).reshape(B, T)
        out = {"tokens": toks}
        if labels_from_tokens:
            # next-token labels from the recovered stream
            out["labels"] = torch.cat(
                [toks[:, 1:], torch.full((B, 1), -1, dtype=torch.int32,
                                         device=toks.device)], dim=1)
        elif "labels" in batch:
            out["labels"] = batch["labels"]
        return out

    return decrypt


class EncryptedSource:
    """Wraps a source: yields HHE-encrypted batches (step t on counters
    [t·bpb, (t+1)·bpb) of the cipher's nonce)."""

    def __init__(self, source, cipher: Cipher):
        self.source = source
        self.cipher = cipher

    def blocks_per_batch(self) -> int:
        return _blocks_for(self.source.batch * self.source.seq_len,
                           self.cipher.params.l)

    def batch_at(self, step: int) -> dict:
        plain = self.source.batch_at(step)
        return encrypt_tokens(self.cipher, plain["tokens"],
                              step * self.blocks_per_batch())


class FarmEncryptedSource:
    """Encrypted source backed by a CipherBatch session and the keystream
    farm, on the same counters as `EncryptedSource`; decrypt with
    ``make_decryptor(batch.session_cipher(src.session.index))``.

    `batch_at` is random access (produce and consume on demand); `stream`
    is the pipelined path, each step one farm window.  ``engine``,
    ``variant`` and ``depth`` configure the farm; ``plan`` applies a
    measured :class:`repro_torch.core.tuner.StreamPlan` (its window is
    moot: a step is one window of ``blocks_per_batch`` lanes).
    """

    def __init__(self, source, batch: CipherBatch,
                 session: Optional[StreamSession] = None, engine=None,
                 variant: Optional[str] = None, depth: Optional[int] = None,
                 plan=None):
        self.source = source
        self.batch = batch
        self.session = session if session is not None else batch.add_session()
        self.farm = KeystreamFarm(batch, engine=engine, variant=variant,
                                  depth=depth, plan=plan)

    @property
    def cipher(self) -> Cipher:
        """Single-stream view (for decryptors and cross-checks)."""
        return self.batch.session_cipher(self.session.index)

    def blocks_per_batch(self) -> int:
        return _blocks_for(self.source.batch * self.source.seq_len,
                           self.batch.params.l)

    def _plan(self, step: int) -> WindowPlan:
        bpb = self.blocks_per_batch()
        ctrs = step * bpb + np.arange(bpb, dtype=np.int64)
        return WindowPlan(np.full(bpb, self.session.index, np.int64), ctrs)

    def _encrypt(self, step: int, z) -> dict:
        return _encrypted(self.batch.params.mod,
                          self.source.batch_at(step)["tokens"], z,
                          step * self.blocks_per_batch())

    def batch_at(self, step: int) -> dict:
        return self._encrypt(step, self.farm.run_one(self._plan(step)))

    def stream(self, start_step: int = 0, n_steps: Optional[int] = None):
        """Pipelined batch iterator (see the class docstring)."""

        def plans():
            step = start_step
            while n_steps is None or step < start_step + n_steps:
                yield self._plan(step)
                step += 1

        for step, (_, z) in enumerate(self.farm.run(plans()), start_step):
            yield self._encrypt(step, z)
