"""Deterministic, resumable data pipeline.

The port's copy of `repro.data.pipeline` (numpy only, so its batches are
the reference's arrays exactly):
  * determinism: batch t is a pure function of (seed, step), so a restart
    replays identically;
  * resumability: the iterator's state is the step counter, carried in a
    checkpoint's ``extra`` dict.

Two sources: a synthetic LM stream (default; markov-ish so loss decreases)
and a memory-mapped token file.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class PipelineState:
    step: int = 0


class SyntheticLM:
    """Deterministic synthetic token stream with learnable structure.

    Tokens follow a fixed (seed-keyed) permutation bigram with 15% uniform
    noise, so even small models show decreasing loss.
    """

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        B, T, V = self.batch, self.seq_len, self.cfg.vocab
        perm = np.random.default_rng(self.seed).permutation(V)
        x = np.zeros((B, T + 1), np.int64)
        x[:, 0] = rng.integers(0, V, B)
        noise = rng.random((B, T + 1))
        rand = rng.integers(0, V, (B, T + 1))
        for t in range(1, T + 1):
            nxt = perm[x[:, t - 1]]
            x[:, t] = np.where(noise[:, t] < 0.15, rand[:, t], nxt)
        toks = x[:, :-1].astype(np.int32)
        labels = x[:, 1:].astype(np.int32)
        return {"tokens": toks, "labels": labels}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class TokenFile:
    """Memory-mapped flat token file (uint16/uint32), deterministic strided
    batching keyed by step."""

    def __init__(self, path: str, cfg: ModelConfig, batch: int, seq_len: int,
                 dtype=np.uint16):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len

    def batch_at(self, step: int) -> dict:
        B, T = self.batch, self.seq_len
        n = len(self.tokens) - (T + 1)
        rng = np.random.default_rng(step)
        starts = rng.integers(0, n, B)
        rows = np.stack([self.tokens[s : s + T + 1] for s in starts])
        return {"tokens": rows[:, :-1].astype(np.int32),
                "labels": rows[:, 1:].astype(np.int32)}


def make_source(cfg: ModelConfig, batch: int, seq_len: int, *,
                path: Optional[str] = None, seed: int = 0):
    if path:
        return TokenFile(path, cfg, batch, seq_len)
    return SyntheticLM(cfg, batch, seq_len, seed=seed)


def iterate_batches(source, start_step: int = 0,
                    n_steps: Optional[int] = None):
    """Streaming iterator over any source.

    A source with its own pipelined ``stream`` method (e.g.
    :class:`repro_torch.data.encrypted.FarmEncryptedSource`, whose
    keystream producer for batch t+1 overlaps batch t) is consumed through
    it; plain random-access sources fall back to ``batch_at``.  Restart
    from a checkpointed step via ``start_step``.
    """
    if hasattr(source, "stream"):
        yield from source.stream(start_step, n_steps)
        return
    step = start_step
    while n_steps is None or step < start_step + n_steps:
        yield source.batch_at(step)
        step += 1
