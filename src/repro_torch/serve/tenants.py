"""Per-tenant key registry for the multi-tenant serving plane.

The port's copy of `repro.serve.tenants`.  Each tenant owns its own
symmetric key: a whole :class:`repro_torch.core.cipher.CipherBatch` pool
plus an event-driven :class:`repro_torch.serve.hhe_loop.HHEServer`.
Inside a tenant, per-client sessions own (nonce, counter) spaces with live
rotation.  Tenants never share a CipherBatch, an engine binding or a farm
pipeline, so no key can leak across tenants.

The registry is bounded: ``capacity`` caps live tenants, and creating one
past the cap evicts the least-recently-active *idle* tenant first.  A
tenant with un-materialized lanes or uncollected responses is never
evicted (``HHEServer.busy()``): the registry grows past capacity instead,
counted in :meth:`TenantRegistry.stats`.  Eviction drops the registry's
only reference to the tenant, so its farm's device planes go back to the
caching allocator.  A re-attached tenant id gets a new generation and a
new pool: its key is derived again from the tenant id and the registry
seed, its sessions are gone, and the client must re-provision
(``hello``).

Every tenant lives on the registry's ``device`` (None = the card).
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np

from repro_torch.core.cipher import CipherBatch, StreamSession
from repro_torch.core.params import get_params
from repro_torch.device import resolve_device
from repro_torch.serve.hhe_loop import HHEServer


def derive_tenant_key(cipher: str, tenant_id: str, seed: int) -> np.ndarray:
    """Deterministic per-tenant key: SHA-256(cipher, tenant_id, seed)
    seeds the key sampler, so a tenant's key differs from every other
    tenant's while tests and benches can reconstruct it.  Numpy only: the
    same key as the reference's for the same arguments."""
    params = get_params(cipher)
    digest = hashlib.sha256(
        f"{cipher}|{tenant_id}|{seed}".encode()).digest()
    rng = np.random.default_rng(np.frombuffer(digest, np.uint64))
    return rng.integers(1, params.mod.q, size=(params.n,), dtype=np.uint32)


@dataclasses.dataclass
class Tenant:
    """One tenant's serving state: its key's pool + event-driven server."""

    tenant_id: str
    batch: CipherBatch
    server: HHEServer
    created_t: float
    last_active_t: float
    generation: int = 0       # bumped when an evicted id is re-created

    def touch(self) -> None:
        self.last_active_t = time.monotonic()


class TenantRegistry:
    """tenant_id -> :class:`Tenant`, LRU-bounded, eviction-safe for
    in-flight work.

    All per-tenant servers share the scheduler configuration given here
    (window, engine, variant, depth, matrix_depth, deadline, admission
    bound and policy); keys are never shared.  Thread-safe: the TCP front
    end touches it from its worker thread.
    """

    def __init__(self, cipher: str = "hera-80", *, capacity: int = 8,
                 window: Optional[int] = None, engine=None,
                 variant: Optional[str] = None, depth: Optional[int] = None,
                 matrix_depth: Optional[int] = None,
                 fire_on_fill: bool = True,
                 deadline_s: Optional[float] = None,
                 max_pending_lanes: Optional[int] = None,
                 overload: str = "reject", seed: int = 0,
                 warmup: bool = False, device=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.cipher = cipher
        self.params = get_params(cipher)
        self.device = resolve_device(device)
        self.capacity = capacity
        self.seed = seed
        self.warmup = warmup
        self._server_kw = dict(
            window=window, engine=engine, variant=variant, depth=depth,
            matrix_depth=matrix_depth, fire_on_fill=fire_on_fill,
            deadline_s=deadline_s, max_pending_lanes=max_pending_lanes,
            overload=overload,
        )
        self._tenants: "OrderedDict[str, Tenant]" = OrderedDict()
        self._generations: dict = {}
        self.evictions = 0
        self.busy_overflows = 0   # creations past capacity with no evictable
        self._lock = threading.RLock()

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._tenants)

    def __contains__(self, tenant_id: str) -> bool:
        return tenant_id in self._tenants

    def tenant_ids(self):
        with self._lock:
            return list(self._tenants)

    def peek(self, tenant_id: str) -> Tenant:
        """Fetch WITHOUT LRU-touching — for pollers (the serving plane's
        deadline ticker) whose visits must not count as tenant activity."""
        with self._lock:
            t = self._tenants.get(tenant_id)
            if t is None:
                raise KeyError(f"unknown tenant {tenant_id!r}")
            return t

    def get(self, tenant_id: str, create: bool = True) -> Tenant:
        """Fetch (and LRU-touch) a tenant, creating it on first sight.

        Creation past ``capacity`` evicts the least-recently-active IDLE
        tenant; if every tenant is busy the registry grows instead —
        dropping live work to honor a size bound would corrupt client
        streams.
        """
        with self._lock:
            t = self._tenants.get(tenant_id)
            if t is not None:
                self._tenants.move_to_end(tenant_id)
                t.touch()
                return t
            if not create:
                raise KeyError(f"unknown tenant {tenant_id!r}")
            if len(self._tenants) >= self.capacity:
                self._evict_one_idle()
            t = self._create(tenant_id)
            self._tenants[tenant_id] = t
            return t

    def _create(self, tenant_id: str) -> Tenant:
        key = derive_tenant_key(self.cipher, tenant_id, self.seed)
        batch = CipherBatch(self.params, key=key,
                            seed=self.seed ^ (hash(tenant_id) & 0x7FFFFFFF),
                            device=self.device)
        server = HHEServer(batch, **self._server_kw)
        if self.warmup:
            batch.add_session()
            server.warmup()
        gen = self._generations.get(tenant_id, -1) + 1
        self._generations[tenant_id] = gen
        now = time.monotonic()
        return Tenant(tenant_id=tenant_id, batch=batch, server=server,
                      created_t=now, last_active_t=now, generation=gen)

    def _evict_one_idle(self) -> bool:
        """Drop the least-recently-active tenant with NO in-flight work.
        Returns False (and counts an overflow) when everyone is busy."""
        for tid, t in self._tenants.items():      # OrderedDict = LRU order
            if not t.server.busy():
                del self._tenants[tid]
                self.evictions += 1
                return True
        self.busy_overflows += 1
        return False

    def evict(self, tenant_id: str, force: bool = False) -> bool:
        """Explicit eviction; refuses on a busy tenant unless ``force``."""
        with self._lock:
            t = self._tenants.get(tenant_id)
            if t is None:
                return False
            if t.server.busy() and not force:
                raise RuntimeError(
                    f"tenant {tenant_id!r} has in-flight work "
                    f"({t.server.pending_lanes()} lanes); flush first or "
                    "force=True")
            del self._tenants[tenant_id]
            self.evictions += 1
            return True

    # ------------------------------------------------------------------
    # per-tenant conveniences the front end calls
    # ------------------------------------------------------------------
    def open_session(self, tenant_id: str) -> StreamSession:
        t = self.get(tenant_id)
        return t.server.open_session()

    def rotate_session(self, tenant_id: str, session_id: int
                       ) -> StreamSession:
        """Live key-material rotation under traffic: materialize the
        tenant's pending lanes (old nonce), then swap in a fresh nonce via
        `CipherBatch.rotate_session`."""
        t = self.get(tenant_id, create=False)
        t.touch()
        # hold the server lock ACROSS quiesce + swap: a submit slipping in
        # between would buffer old-nonce lanes that then materialize under
        # the new nonce.  quiesce (not flush) so the responses stay queued
        # for whoever owns delivery (the front end's future resolution).
        with t.server._lock:
            t.server.quiesce()
            return t.batch.rotate_session(session_id)

    def stats(self) -> dict:
        with self._lock:
            return {
                "cipher": self.cipher,
                "capacity": self.capacity,
                "tenants": len(self._tenants),
                "evictions": self.evictions,
                "busy_overflows": self.busy_overflows,
                "per_tenant": {
                    tid: t.server.latency_stats()
                    for tid, t in self._tenants.items()
                },
            }
