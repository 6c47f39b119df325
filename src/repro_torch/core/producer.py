"""Constants-producer registry: the producer half of the paper's T3 split.

The port's copy of `repro.core.producer`.  A producer turns (session
material, per-lane session ids, block counters) into the constants dict
the engines consume: ``rc`` (lanes, n_round_constants) int64, ``noise``
(lanes, l) int64 signed or None, ``mats`` (lanes, n_matrix_constants)
int64 or None.  The key never enters.

Registered producers (`registered_producers()` / `producer_caps()`):

  * ``aes``      — AES-128-CTR XOF, the paper's conformance stream.  On a
                   CUDA device its words come from the AES kernel
                   (`kernels.aes.ops.aes_xof_words`); on the CPU the
                   kernel's plain version runs instead.
  * ``threefry`` — JAX's counter-based threefry2x32 PRF, a different
                   stream; plain PyTorch on either device (the reference
                   computes it in XLA, outside any Pallas kernel).
  * ``cached``   — memoizing wrapper over the stream-matching producer:
                   a repeated (session nonce, counter window, plane kind)
                   returns the memoized planes.

The samplers read the XOF's words as the XOF left them: on a CUDA device
the sampler kernels (`kernels.sampler.ops`) run, on the CPU their plain
versions (`crypto/sampler.py`).  ``ProducerCaps.stream`` names the XOF
stream a producer emits; None follows ``params.xof`` (the wrapper).
Producers whose stream matches ``params.xof`` are interchangeable without
changing a keystream bit (`compatible_producers`).

Usage:

    prod = make_producer(None, params, device="cuda")
    mat = prod.session_material(nonce)          # host-side, once/session
    tables = prod.stack_tables([mat, ...])      # device tables
    consts = prod.produce(tables, session_ids, block_ctrs)

``python -m repro_torch.core.producer`` prints the registry table.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Type, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.params import CipherParams
from repro_torch.crypto.aes import aes128_key_expand
from repro_torch.crypto.sampler import (
    DGaussTable,
    words_needed_uniform_stream,
)
from repro_torch.crypto.xof import (
    threefry_root_key,
    threefry_xof_words_batched,
)
from repro_torch.device import resolve_device, upload
from repro_torch.kernels.aes.ops import aes_xof_words
from repro_torch.kernels.sampler.ops import (
    gauss_kernel_apply,
    uniform_kernel_apply,
)

#: Constants-plane kinds a producer can materialize independently.
PLANES = ("all", "vector", "matrix")


def constants_from_words(params: CipherParams, words,
                         gauss: Optional[DGaussTable], plane: str = "all"):
    """Shared producer tail: XOF words -> dict(rc=..., noise=..., mats=...).

    words: (..., total) XOF words as the XOF left them: int32 bit patterns
    (the AES kernel's) or int64 values (threefry's); the samplers read
    either without a widening copy.  The word layout is fixed: rc words
    first, then noise hi, noise lo, then matrix-plane words — the matrix
    plane draws strictly after the vector plane from the same stream, so
    presets without matrices are unaffected by it.
    """
    if plane not in PLANES:
        raise ValueError(f"unknown constants plane {plane!r}; have {PLANES}")
    p = params
    n_u = p.n_round_constants
    w_u = words_needed_uniform_stream(n_u)
    out: Dict[str, Any] = {}
    if plane in ("all", "vector"):
        with obs.span("producer.uniform", stream=words):
            out["rc"] = uniform_kernel_apply(words[..., :w_u], n_u, p.mod)
        noise = None
        if p.n_noise:
            hi = words[..., w_u : w_u + p.n_noise]
            lo = words[..., w_u + p.n_noise : w_u + 2 * p.n_noise]
            with obs.span("producer.gauss", stream=words):
                noise = gauss_kernel_apply(hi, lo, gauss)
        out["noise"] = noise
    if plane in ("all", "matrix"):
        mats = None
        if p.n_matrix_constants:
            base = w_u + 2 * p.n_noise
            n_m = p.n_matrix_constants
            w_m = words_needed_uniform_stream(n_m)
            with obs.span("producer.uniform", stream=words):
                mats = uniform_kernel_apply(words[..., base : base + w_m],
                                            n_m, p.mod)
        out["mats"] = mats
    return out


class SessionMaterial(NamedTuple):
    """Host-side per-session producer material: the raw 16-byte nonce and
    backend-specific precompiled material (expanded AES round keys, ...)."""

    nonce: bytes
    payload: Any


class ProducerTables(NamedTuple):
    """Stacked session tables on the producer's device, plus the nonce
    identities they were stacked from (parallel to the session axis)."""

    device: Any
    nonces: Tuple[bytes, ...]


@dataclasses.dataclass(frozen=True)
class ProducerCaps:
    """What one producer backend can do, queried without instantiating it.
    ``stream`` names the XOF stream it emits (None: it follows
    ``params.xof``); ``memoizes`` marks backends that reuse materialized
    constants for repeated windows."""

    name: str
    description: str
    available: bool
    reason: str = ""
    stream: Optional[str] = None
    memoizes: bool = False


class ConstantsProducer:
    """One way to materialize round constants (+ noise) from counters,
    bound to ``params`` and a device at construction."""

    name: str = "?"

    def __init__(self, params: CipherParams, device=None):
        self.params = params
        self.device = resolve_device(device)
        self._gauss = (
            DGaussTable.build(params.sigma) if params.n_noise else None
        )
        #: XOF words the vector plane (constants + noise) consumes
        self.vector_words = (
            words_needed_uniform_stream(params.n_round_constants)
            + 2 * params.n_noise
        )
        #: XOF words one lane consumes in total (+ matrix planes)
        self.total_words = params.xof_words_per_block()
        self.caps = type(self).query_caps()

    @classmethod
    def query_caps(cls) -> ProducerCaps:
        raise NotImplementedError

    def session_material(self, nonce) -> SessionMaterial:
        raise NotImplementedError

    def _stack_payloads(self, materials: List[SessionMaterial]):
        raise NotImplementedError

    def stack_tables(self, materials: List[SessionMaterial]) -> ProducerTables:
        return ProducerTables(
            self._stack_payloads(materials),
            tuple(m.nonce for m in materials),
        )

    def plane_words(self, plane: str = "all") -> int:
        """XOF words one lane draws to materialize ``plane`` (a matrix-only
        pass still draws the vector-plane prefix of the stream)."""
        if plane == "vector" or not self.params.n_matrix_constants:
            return self.vector_words
        return self.total_words

    def _lane_arrays(self, tables: ProducerTables, session_ids, block_ctrs):
        with obs.span("producer.upload"):
            sid = np.asarray(session_ids.cpu() if torch.is_tensor(session_ids)
                             else session_ids, np.int64).reshape(-1)
            ctr = np.asarray(block_ctrs.cpu() if torch.is_tensor(block_ctrs)
                             else block_ctrs, np.int64).reshape(-1)
            if sid.shape != ctr.shape:
                raise ValueError("session_ids / block_ctrs length mismatch")
            if sid.size and (sid.min() < 0
                             or sid.max() >= len(tables.nonces)):
                raise IndexError(f"session id out of range for "
                                 f"{len(tables.nonces)} sessions")
            return upload(sid, self.device), upload(ctr, self.device)

    def produce(self, tables: ProducerTables, session_ids, block_ctrs,
                plane: str = "all"):
        """Materialize constants for per-lane (session, counter) pairs on
        the producer's device, filtered to the requested plane."""
        raise NotImplementedError

    def constants_for_nonce(self, nonce, block_ctrs):
        """Single-stream path: one nonce, a vector of counters (Cipher)."""
        tables = self.stack_tables([self.session_material(nonce)])
        ctrs = np.asarray(block_ctrs, np.int64).reshape(-1)
        return self.produce(tables, np.zeros(ctrs.shape, np.int64), ctrs)

    def __repr__(self):
        return f"<ConstantsProducer {self.name} params={self.params.name}>"


# ==========================================================================
# Registry
# ==========================================================================
_REGISTRY: Dict[str, Type[ConstantsProducer]] = {}


def register_producer(cls: Type[ConstantsProducer]) -> Type[ConstantsProducer]:
    if cls.name in _REGISTRY:
        raise ValueError(f"producer {cls.name!r} already registered")
    _REGISTRY[cls.name] = cls
    return cls


def registered_producers() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def producer_caps() -> Dict[str, ProducerCaps]:
    """Capability report for every registered producer."""
    return {name: cls.query_caps() for name, cls in sorted(_REGISTRY.items())}


def compatible_producers(params: CipherParams) -> Tuple[str, ...]:
    """Producers whose stream matches ``params.xof``: interchangeable
    without changing a single keystream bit."""
    return tuple(
        name for name, c in producer_caps().items()
        if c.available and c.stream in (None, params.xof)
    )


def _tuned_producer(params: Optional[CipherParams],
                    device: Optional[torch.device]) -> Optional[str]:
    """The producer of the tuner's cached plan for (preset, this host and
    device), or None: no ``params`` or ``device`` context, or no valid
    plan (`load_plan` trusts only available, stream-preserving
    producers)."""
    if params is None or device is None:
        return None
    from repro_torch.core.tuner import load_plan

    plan = load_plan(params, lanes=None, device=device)
    return None if plan is None else plan.producer


def resolve_producer(spec: Optional[str],
                     params: Optional[CipherParams] = None,
                     device=None) -> str:
    """THE single place producer selection lives.  ``spec`` is a producer
    name, None (= the preset's declared XOF, ``params.xof``, static) or
    "auto" (= the tuner's measured `StreamPlan` for (preset, this host,
    ``device``) when one is cached, else as None).  Plans are scoped to a
    device, so a bare name lookup without ``device`` has none to consult."""
    if spec == "auto":
        spec = _tuned_producer(
            params, None if device is None else torch.device(device))
    if spec is None:
        spec = params.xof if params is not None else "aes"
    if spec not in _REGISTRY:
        raise ValueError(
            f"unknown constants producer {spec!r}; registered producers: "
            f"{list(registered_producers())} (plus 'auto'; run "
            "`python -m repro_torch.core.producer` for the table)"
        )
    return spec


ProducerSpec = Union[str, ConstantsProducer, None]


def make_producer(spec: ProducerSpec, params: CipherParams, *,
                  device=None, **kwargs) -> ConstantsProducer:
    """Resolve ``spec`` and bind it to (params, device); ``kwargs`` go to
    the backend (``inner``/``max_entries`` of ``cached``).  An instance
    passes through if it is bound to the same params and device."""
    if isinstance(spec, ConstantsProducer):
        if spec.params != params:
            raise ValueError(
                f"producer {spec.name!r} is bound to different params "
                f"(producer has {spec.params.name})")
        if device is not None and spec.device != resolve_device(device):
            raise ValueError(
                f"producer {spec.name!r} lives on {spec.device}, not "
                f"{device}")
        return spec
    device = resolve_device(device)
    name = resolve_producer(spec, params, device)
    cls = _REGISTRY[name]
    caps = cls.query_caps()
    if not caps.available:
        raise RuntimeError(
            f"constants producer {name!r} unavailable here: {caps.reason}")
    return cls(params, device=device, **kwargs)


# ==========================================================================
# Backends
# ==========================================================================
@register_producer
class AesProducer(ConstantsProducer):
    """AES-128-CTR XOF — the paper's §IV-D conformance stream.  Per-session
    material: expanded round keys and the 12-byte nonce prefix."""

    name = "aes"

    @classmethod
    def query_caps(cls) -> ProducerCaps:
        return ProducerCaps(
            name=cls.name,
            description="AES-128-CTR XOF (paper conformance stream)",
            available=True,
            stream="aes",
        )

    def session_material(self, nonce) -> SessionMaterial:
        nonce = np.asarray(nonce, dtype=np.uint8).reshape(16)
        return SessionMaterial(
            nonce.tobytes(),
            (aes128_key_expand(nonce), nonce[:12].copy()),
        )

    def _stack_payloads(self, materials):
        rk = np.stack([m.payload[0] for m in materials])     # (S, 11, 16)
        n12 = np.stack([m.payload[1] for m in materials])    # (S, 12)
        return (torch.as_tensor(rk, dtype=torch.uint8, device=self.device),
                torch.as_tensor(n12, dtype=torch.uint8, device=self.device))

    def produce(self, tables, session_ids, block_ctrs, plane: str = "all"):
        rk, n12 = tables.device
        sid, ctr = self._lane_arrays(tables, session_ids, block_ctrs)
        with obs.span("producer.xof", stream=self.device):
            words = aes_xof_words(rk, n12, sid, ctr, self.plane_words(plane))
        return constants_from_words(self.params, words, self._gauss, plane)


@register_producer
class ThreefryProducer(ConstantsProducer):
    """Counter-based threefry2x32 PRF — the reference's TPU-native fast
    stream.  Per-session material: the root key data."""

    name = "threefry"

    @classmethod
    def query_caps(cls) -> ProducerCaps:
        return ProducerCaps(
            name=cls.name,
            description="threefry2x32 counter PRF (plain PyTorch)",
            available=True,
            stream="threefry",
        )

    def session_material(self, nonce) -> SessionMaterial:
        nonce = np.asarray(nonce, dtype=np.uint8).reshape(16)
        return SessionMaterial(nonce.tobytes(), threefry_root_key(nonce))

    def _stack_payloads(self, materials):
        roots = np.stack([m.payload for m in materials]).astype(np.int64)
        return (torch.as_tensor(roots, device=self.device),)    # (S, 2)

    def produce(self, tables, session_ids, block_ctrs, plane: str = "all"):
        (roots,) = tables.device
        sid, ctr = self._lane_arrays(tables, session_ids, block_ctrs)
        with obs.span("producer.xof", stream=self.device):
            words = threefry_xof_words_batched(roots[sid], ctr,
                                               self.plane_words(plane))
        return constants_from_words(self.params, words, self._gauss, plane)


@register_producer
class CachedProducer(ConstantsProducer):
    """Memoizing wrapper over the stream-matching producer.

    A repeated (per-lane nonces, counters, plane kind) request returns the
    memoized planes instead of re-running the XOF.  The nonces are read
    from the `ProducerTables` each call uses, never from instance state,
    so a rotation (fresh nonce) never serves a stale plane and an instance
    shared between pools never mixes them up; the plane kind keeps a
    vector plane from answering a matrix-plane request.  Entries are
    LRU-evicted past ``max_entries`` windows; they hold device tensors.
    Bit-exact with the inner producer by construction.  (The reference
    bypasses its cache under a jax trace; PyTorch runs eagerly, so every
    call has host-side ids to key on and there is no bypass.)
    """

    name = "cached"
    MAX_ENTRIES = 64

    def __init__(self, params: CipherParams, device=None, *,
                 inner: Optional[str] = None,
                 max_entries: Optional[int] = None):
        super().__init__(params, device=device)
        inner = inner if inner is not None else params.xof
        if inner == self.name:
            raise ValueError("cached producer cannot wrap itself")
        self.inner = make_producer(inner, params, device=self.device)
        self.max_entries = max_entries or self.MAX_ENTRIES
        self._cache: "OrderedDict[tuple, dict]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    @classmethod
    def query_caps(cls) -> ProducerCaps:
        return ProducerCaps(
            name=cls.name,
            description="memoizes RC planes for repeated (session, ctr) "
                        "windows over the stream-matching producer",
            available=True,
            stream=None,          # follows params.xof (the inner stream)
            memoizes=True,
        )

    # material/tables delegate to the inner backend; the nonce identities
    # the cache keys on ride on the ProducerTables themselves
    def session_material(self, nonce) -> SessionMaterial:
        return self.inner.session_material(nonce)

    def _stack_payloads(self, materials):
        return self.inner._stack_payloads(materials)

    @staticmethod
    def _key(tables: ProducerTables, session_ids, block_ctrs,
             plane: str = "all"):
        def host(x):
            return np.asarray(x.cpu() if torch.is_tensor(x) else x,
                              np.int64).reshape(-1)

        sid, ctr = host(session_ids), host(block_ctrs)
        try:
            nonces = b"".join(tables.nonces[int(s)] for s in sid)
        except IndexError:   # lanes beyond the stacked tables: don't cache
            return None
        return (plane, nonces, ctr.tobytes())

    def produce(self, tables, session_ids, block_ctrs, plane: str = "all"):
        key = self._key(tables, session_ids, block_ctrs, plane)
        if key is not None and key in self._cache:
            self.hits += 1
            self._cache.move_to_end(key)
            return self._cache[key]
        out = self.inner.produce(tables, session_ids, block_ctrs, plane)
        if key is not None:
            self.misses += 1
            self._cache[key] = out
            while len(self._cache) > self.max_entries:
                self._cache.popitem(last=False)
        return out

    def cache_stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "entries": len(self._cache),
            "hit_rate": self.hits / total if total else 0.0,
        }


# ==========================================================================
# Introspection CLI: `python -m repro_torch.core.producer`
# ==========================================================================
def describe() -> str:
    """The producer registry as a table: one row per backend, with
    availability, stream identity, and memoization."""
    caps = producer_caps()
    rows = [("producer", "available", "stream", "memoizes",
             "description / reason")]
    for name, c in caps.items():
        stream = c.stream if c.stream is not None else "(params.xof)"
        detail = c.description if c.available else f"UNAVAILABLE: {c.reason}"
        rows.append((name, "yes" if c.available else "no", stream,
                     "yes" if c.memoizes else "no", detail))
    widths = [max(len(r[i]) for r in rows) for i in range(4)]
    lines = []
    for i, r in enumerate(rows):
        lines.append("  ".join(r[j].ljust(widths[j]) for j in range(4))
                     + "  " + r[4])
        if i == 0:
            lines.append("  ".join("-" * w for w in widths) + "  " + "-" * 24)
    return "\n".join(lines)


if __name__ == "__main__":
    print(describe())
