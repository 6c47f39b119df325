"""Client-side cipher API: keystream / encrypt / decrypt, single-stream and
session-batched.

The port's copy of `repro.core.cipher`.  The producer (XOF + samplers,
`core/producer.py`) depends only on (nonce, block counters); the consumer
(a `core/engine.py` engine) turns constants into keystream with the key.
A :class:`CipherBatch` holds one key and a pool of :class:`StreamSession`
s; its producer and consumer take per-lane (session, counter) pairs, so one
call serves lanes from any number of concurrent clients, bit-exact with
each session's own single-stream :class:`Cipher`.

Everything lives on one device, ``device=None`` meaning the card.  Keys
and nonces are drawn from ``np.random.default_rng(seed)`` in the same
order as the reference, so a seed gives the same cipher in both packages.

Message encoding: m_q = round(m·Δ) centered into Z_q (float32 multiply,
round half to even, as the reference's `jnp.round`); c = m_q + z; m_q = c − z.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.engine import EngineSpec, make_engine
from repro_torch.core.params import CipherParams, get_params
from repro_torch.core.producer import (
    ConstantsProducer,
    ProducerSpec,
    SessionMaterial,
    make_producer,
)
from repro_torch.device import resolve_device


def encode_fixed(mod, m_real, delta: float):
    """Fixed-point encode: m_q = round(m·Δ) centered into Z_q (int64)."""
    m = torch.as_tensor(np.asarray(m_real, np.float32)
                        if not torch.is_tensor(m_real) else m_real)
    mq = torch.round(m.to(torch.float32) * delta).to(torch.int32)
    return mod.from_signed(mq)


def decode_fixed(mod, m_q, delta: float):
    """Inverse of :func:`encode_fixed` (float32)."""
    return mod.to_signed(m_q).to(torch.float32) / delta


def as_int64(x, device):
    """Integer array or tensor (e.g. uint32 ciphertext) -> int64 tensor."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x).astype(np.int64), device=device)


def _key_array(params: CipherParams, key) -> np.ndarray:
    k = np.asarray(key.cpu() if torch.is_tensor(key) else key, np.int64)
    if k.shape != (params.n,):
        raise ValueError(f"key shape {k.shape} != ({params.n},)")
    return k


@dataclasses.dataclass
class Cipher:
    params: CipherParams
    key: object               # (n,) ints in Z_q — the symmetric secret
    nonce: np.ndarray         # (16,) uint8, public
    engine: EngineSpec = "ref"
    producer: ProducerSpec = None
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.key = torch.as_tensor(_key_array(self.params, self.key),
                                   device=self.device)
        self.nonce = np.asarray(self.nonce, dtype=np.uint8).reshape(16)
        self._producer = make_producer(self.producer, self.params,
                                       device=self.device)
        self._engine = make_engine(self.engine, self.params, self.key,
                                   device=self.device)

    def round_constant_stream(self, block_ctrs):
        """dict(rc=(lanes, n_round_constants), noise=(lanes, l) | None,
        mats=... | None) for (lanes,) block counters."""
        return self._producer.constants_for_nonce(self.nonce, block_ctrs)

    def keystream_from_constants(self, rc, noise=None, mats=None):
        return self._engine.keystream_from_constants(rc, noise, mats)

    def keystream(self, block_ctrs, constants=None):
        """(lanes,) block counters -> (lanes, l) int64 keystream."""
        if constants is None:
            constants = self.round_constant_stream(block_ctrs)
        return self.keystream_from_constants(
            constants["rc"], constants["noise"], constants.get("mats")
        )

    def keystream_coupled(self, block_ctrs):
        """D1-style baseline: sample ALL constants, then run the rounds,
        with no overlap.  On the card one synchronize between the two
        stands in for the reference's ``optimization_barrier``."""
        c = self.round_constant_stream(block_ctrs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.keystream_from_constants(c["rc"], c["noise"],
                                             c.get("mats"))

    def encode(self, m_real, delta: float):
        return encode_fixed(self.params.mod, m_real, delta).to(self.device)

    def decode(self, m_q, delta: float):
        return decode_fixed(self.params.mod, m_q, delta)

    def encrypt(self, m_real, block_ctrs, delta: float = 1024.0,
                constants=None):
        z = self.keystream(block_ctrs, constants)
        return self.params.mod.add(self.encode(m_real, delta), z)

    def decrypt(self, c, block_ctrs, delta: float = 1024.0, constants=None):
        z = self.keystream(block_ctrs, constants)
        return self.decode(self.params.mod.sub(as_int64(c, z.device), z),
                           delta)


def make_cipher(name: str, key=None, nonce=None, seed: int = 0,
                engine: EngineSpec = "ref", producer: ProducerSpec = None,
                device=None) -> Cipher:
    """Convenience constructor; key/nonce drawn from ``seed`` if omitted,
    exactly as the reference draws them."""
    p = get_params(name)
    rng = np.random.default_rng(seed)
    if key is None:
        key = rng.integers(1, p.mod.q, size=(p.n,), dtype=np.uint32)
    if nonce is None:
        nonce = rng.integers(0, 256, size=(16,), dtype=np.uint8)
    return Cipher(p, key, nonce, engine, producer, device)


#: Block counters per session: each cipher-block counter owns a 2^16-block
#: subspace of the 32-bit AES counter, so counters >= 2^16 would alias
#: earlier XOF streams (a two-time pad).
SESSION_CTR_LIMIT = 1 << 16


@dataclasses.dataclass
class StreamSession:
    """One client stream: public nonce + a block-counter window cursor."""

    index: int
    nonce: np.ndarray          # (16,) uint8, public
    next_ctr: int = 0
    generation: int = 0        # bumped by CipherBatch.rotate_session

    def __post_init__(self):
        self.nonce = np.asarray(self.nonce, dtype=np.uint8).reshape(16)

    def remaining(self) -> int:
        return SESSION_CTR_LIMIT - self.next_ctr

    def take_window(self, n_blocks: int) -> np.ndarray:
        """Reserve the next ``n_blocks`` counters; advances the cursor."""
        if self.next_ctr + n_blocks > SESSION_CTR_LIMIT:
            raise RuntimeError(
                f"session {self.index} counter space exhausted "
                f"({self.next_ctr} + {n_blocks} > {SESSION_CTR_LIMIT}); "
                "rotate_session (fresh nonce) instead of reusing keystream"
            )
        ctrs = np.arange(
            self.next_ctr, self.next_ctr + n_blocks, dtype=np.uint32
        )
        self.next_ctr += n_blocks
        return ctrs


class CipherBatch:
    """Session-batched cipher: one symmetric key, a pool of stream sessions,
    all on one device."""

    def __init__(self, params: CipherParams | str, key=None, seed: int = 0,
                 engine: EngineSpec = "ref", producer: ProducerSpec = None,
                 device=None):
        if isinstance(params, str):
            params = get_params(params)
        self.params = params
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        if key is None:
            key = rng.integers(1, params.mod.q, size=(params.n,),
                               dtype=np.uint32)
        self.key = torch.as_tensor(_key_array(params, key),
                                   device=self.device)
        self._rng = rng
        self._engine = self.make_engine(engine)
        self.producer: ConstantsProducer = make_producer(
            producer, params, device=self.device)
        self.sessions: List[StreamSession] = []
        self._mat_host: List[SessionMaterial] = []
        self._tables = None                       # device tables, lazy

    def make_engine(self, spec: EngineSpec = "auto", *,
                    variant: Optional[str] = None,
                    reduction: Optional[str] = None):
        """Bind a consumer engine to this pool's (params, key, device)."""
        return make_engine(spec, self.params, self.key, device=self.device,
                           variant=variant, reduction=reduction)

    # ---------------- producer plumbing -----------------------------------
    def set_producer(self, spec: ProducerSpec) -> ConstantsProducer:
        """Swap the RNG backend in place; per-session material is rebuilt
        from the live nonces, so sessions keep their (nonce, counter)
        spaces.  Only stream-preserving swaps are allowed: on another XOF
        stream the same (nonce, ctr) pairs would give other keystream and
        clients' earlier ciphertexts would decrypt to garbage, so a
        mismatched spec raises (a different stream is chosen at
        construction)."""
        prod = make_producer(spec, self.params, device=self.device)
        if prod.caps.stream not in (None, self.params.xof):
            raise ValueError(
                f"producer {prod.name!r} emits the {prod.caps.stream!r} "
                f"stream but this pool's preset declares "
                f"{self.params.xof!r}; swapping a live pool across streams "
                "would silently change every keystream — construct a new "
                "CipherBatch for a different stream"
            )
        self.producer = prod
        self._mat_host = [
            self.producer.session_material(s.nonce) for s in self.sessions
        ]
        self._tables = None
        return self.producer

    # ---------------- session pool ---------------------------------------
    def add_session(self, nonce=None) -> StreamSession:
        if nonce is None:
            nonce = self._rng.integers(0, 256, size=(16,), dtype=np.uint8)
        s = StreamSession(index=len(self.sessions), nonce=nonce)
        self.sessions.append(s)
        self._mat_host.append(self.producer.session_material(s.nonce))
        self._tables = None
        return s

    def add_sessions(self, count: int) -> List[StreamSession]:
        return [self.add_session() for _ in range(count)]

    def rotate_session(self, session_id: int, nonce=None) -> StreamSession:
        """Retire a session's (nonce, counter) space: fresh nonce, cursor 0,
        same index, ``generation`` + 1."""
        old = self.sessions[session_id]
        if nonce is None:
            nonce = self._rng.integers(0, 256, size=(16,), dtype=np.uint8)
        s = StreamSession(index=session_id, nonce=nonce,
                          generation=old.generation + 1)
        self.sessions[session_id] = s
        self._mat_host[session_id] = self.producer.session_material(s.nonce)
        self._tables = None
        return s

    def __len__(self) -> int:
        return len(self.sessions)

    def session_cipher(self, session_id: int) -> Cipher:
        """Single-stream view of one session (the bit-exactness oracle)."""
        return Cipher(self.params, self.key, self.sessions[session_id].nonce,
                      producer=self.producer.name, device=self.device)

    def xof_tables(self):
        """Device-side per-session producer material, rebuilt lazily on
        growth or rotation."""
        if self._tables is None:
            self._tables = self.producer.stack_tables(self._mat_host)
        return self._tables

    # ---------------- producer / consumer ---------------------------------
    def round_constant_stream(self, session_ids, block_ctrs):
        return self.producer.produce(
            self.xof_tables(), session_ids, block_ctrs
        )

    def keystream_from_constants(self, rc, noise=None, mats=None):
        return self._engine.keystream_from_constants(rc, noise, mats)

    def keystream(self, session_ids, block_ctrs, constants=None):
        """(lanes,) (session, ctr) pairs -> (lanes, l) int64 keystream."""
        if constants is None:
            constants = self.round_constant_stream(session_ids, block_ctrs)
        return self.keystream_from_constants(
            constants["rc"], constants["noise"], constants.get("mats")
        )

    def encrypt(self, m_real, session_ids, block_ctrs, delta: float = 1024.0,
                constants=None):
        z = self.keystream(session_ids, block_ctrs, constants)
        mod = self.params.mod
        return mod.add(encode_fixed(mod, m_real, delta).to(z.device), z)

    def decrypt(self, c, session_ids, block_ctrs, delta: float = 1024.0,
                constants=None):
        z = self.keystream(session_ids, block_ctrs, constants)
        mod = self.params.mod
        return decode_fixed(mod, mod.sub(as_int64(c, z.device), z), delta)
