"""HHE request loop: event-driven window scheduling over the keystream farm.

The port's copy of `repro.serve.hhe_loop`.  The server holds ONE symmetric
key and a :class:`repro_torch.core.cipher.CipherBatch` session pool;
requests are packed lane by lane into fixed-size windows and run through
one long-lived :class:`repro_torch.core.farm.FarmPipeline`, so a request of
11 blocks from session A and one of 3 from session B share one kernel
launch, and the producer of the next window overlaps the consumer of the
current one.

A window fires the moment the lane buffer fills (``fire_on_fill``) or when
the oldest queued lane crosses ``deadline_s`` (:meth:`HHEServer.service`).
``max_pending_lanes`` bounds the un-materialized backlog: policy "reject"
raises :class:`HHEServerSaturated`, "shed" drops the request before any
counter is reserved.  Responses are numpy arrays with the reference's
dtypes: uint32 for keystream and ciphertext, float32 for decrypt, int32
for ``decrypt_tokens``.  ``window_latencies`` records, per window, the
seconds from its dispatch to its keystream landing on the host.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch.core.cipher import (
    CipherBatch,
    StreamSession,
    add_words,
    as_int64,
    decrypt_fixed,
    encrypt_fixed,
    sub_words,
)
from repro_torch.core.farm import KeystreamFarm, WindowPlan, pack_windows

OPS = ("keystream", "encrypt", "decrypt", "encrypt_tokens", "decrypt_tokens")

#: admission-control policies when the pending-lane bound is hit
OVERLOAD_POLICIES = ("reject", "shed")


class HHEServerSaturated(RuntimeError):
    """Raised by submit() under the "reject" overload policy: the pending
    window queue is at its configured bound.  Clients should back off and
    retry; nothing was reserved (no counters consumed)."""


@dataclasses.dataclass
class HHERequest:
    """One client request: ``blocks`` keystream blocks on one session.

    op="encrypt":  payload (blocks, l) float32 -> ciphertext (blocks, l) u32.
    op="decrypt":  payload (blocks, l) uint32  -> plaintext (blocks, l) f32.
    op="keystream": no payload -> raw keystream (the transciphering feed).
    op="encrypt_tokens": payload (blocks, l) int token ids (< q) ->
        ciphertext (blocks, l) u32 — exact Z_q encryption, no fixed-point
        encoding (the `launch/serve.py --encrypted` prompt/response path).
    op="decrypt_tokens": payload (blocks, l) u32 -> token ids (blocks, l)
        int32, exact.
    """

    session_id: int
    op: str = "keystream"
    payload: Optional[np.ndarray] = None
    blocks: Optional[int] = None
    delta: float = 1024.0

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"unknown op {self.op!r}; have {OPS}")
        if self.payload is not None:
            self.payload = np.asarray(self.payload)
            if self.blocks is None:
                self.blocks = self.payload.shape[0]
            if self.payload.shape[0] != self.blocks:
                raise ValueError("payload rows != blocks")
        if self.blocks is None or self.blocks <= 0:
            raise ValueError("request needs blocks > 0 (or a payload)")


@dataclasses.dataclass
class HHEResponse:
    request: HHERequest
    result: np.ndarray        # per-op result, (blocks, l)
    block_ctrs: np.ndarray    # counters consumed (client needs these)
    latency_s: float
    seq: int = 0              # submission sequence (flush() sorts on it)


@dataclasses.dataclass
class _Entry:
    """Book-keeping for one submitted request until its last lane lands."""

    seq: int
    req: HHERequest
    ctrs: np.ndarray
    t_submit: float
    rows: np.ndarray          # (blocks, l) u32, filled window by window
    remaining: int
    # sessions can rotate while a request is queued on the OLD nonce; the
    # response must report the nonce its counters were reserved under
    nonce: bytes = b""
    generation: int = 0


class HHEServer:
    """Single-key HHE endpoint: session pool + event-driven window scheduler.

    ``engine`` picks the farm's consumer backend (any registered
    `repro_torch.core.engine` name or instance; "auto" by the pool's
    device); ``devices`` names the devices the ``sharded`` engine splits
    each window over (the reference's ``mesh``); ``depth`` sets the farm's producer→consumer FIFO depth and
    ``matrix_depth`` its matrix-plane prefetch depth (PASTA); ``variant``
    and ``reduction`` pick the schedule orientation plan and reduction
    mode, bit-exact either way.  ``plan`` applies a measured
    :class:`repro_torch.core.tuner.StreamPlan` in one shot: producer,
    engine, variant, depth, matrix_depth, reduction and (when ``window``
    is not given) window size; explicit arguments win.  With
    ``auto_rotate`` (default),
    a session whose counter space cannot fit an incoming request is
    rotated to a fresh nonce (pending lanes on the old nonce materialize
    first), so long-running streams survive counter exhaustion without
    keystream reuse; clients observe rotations via
    ``StreamSession.generation`` and the session's current nonce.

    Scheduler knobs (all optional — defaults reproduce the classic
    submit-then-flush shape):

    * ``fire_on_fill`` (default True): a full window dispatches inside the
      submit that filled it, through the persistent farm pipeline.
    * ``deadline_s``: age bound on the oldest un-materialized lane; when
      it trips, :meth:`service` fires the part-full window (padded via
      `pack_windows`) and drains the pipeline, so tail requests are never
      parked behind an un-filled window.  None = no deadline (drain via
      ``flush``).
    * ``max_pending_lanes`` + ``overload``: admission control — over the
      bound, "reject" raises :class:`HHEServerSaturated`, "shed" drops
      the request (counted in ``latency_stats()["shed"]``) before any
      counters are reserved.
    """

    DEFAULT_WINDOW = 256

    def __init__(self, batch: CipherBatch, window: Optional[int] = None,
                 engine=None, *, devices=None,
                 variant: Optional[str] = None,
                 depth: Optional[int] = None,
                 matrix_depth: Optional[int] = None,
                 reduction: Optional[str] = None, plan=None,
                 auto_rotate: bool = True,
                 fire_on_fill: bool = True,
                 deadline_s: Optional[float] = None,
                 max_pending_lanes: Optional[int] = None,
                 overload: str = "reject"):
        if window is None:
            window = plan.window if plan is not None else self.DEFAULT_WINDOW
        if window <= 0:
            raise ValueError("window must be positive")
        if overload not in OVERLOAD_POLICIES:
            raise ValueError(
                f"unknown overload policy {overload!r}; "
                f"have {OVERLOAD_POLICIES}")
        if max_pending_lanes is not None and max_pending_lanes < window:
            raise ValueError(
                f"max_pending_lanes={max_pending_lanes} below one window "
                f"({window}): no request could ever complete")
        if deadline_s is not None and deadline_s < 0:
            raise ValueError("deadline_s must be >= 0")
        self.batch = batch
        self.window = window
        self.auto_rotate = auto_rotate
        self.fire_on_fill = fire_on_fill
        self.deadline_s = deadline_s
        self.max_pending_lanes = max_pending_lanes
        self.overload = overload
        self.farm = KeystreamFarm(batch, engine=engine, devices=devices,
                                  variant=variant, depth=depth,
                                  matrix_depth=matrix_depth,
                                  reduction=reduction, plan=plan)
        # ONE long-lived pipeline: windows fired by different scheduling
        # events still overlap producer-vs-consumer across the FIFO
        self._pipe = self.farm.pipeline()
        # undispatched lanes: [entry, ctrs int64 array, consumed offset]
        self._frags: Deque[list] = deque()
        self._buffered = 0                # lanes in _frags
        self._inflight = 0                # valid lanes dispatched, unmaterialized
        self._pending_windows: Deque[WindowPlan] = deque()
        self._completed: List[HHEResponse] = []
        self._seq = 0
        self.latencies: List[float] = []
        self.window_latencies: List[float] = []
        self.windows_served = 0
        self.fill_fires = 0
        self.deadline_fires = 0
        self.shed_count = 0
        self.rejected_count = 0
        # submit may run on one thread while service/flush run on another
        # (an async front end) — one reentrant lock serializes every
        # scheduler mutation
        self._lock = threading.RLock()

    # ------------------------------------------------------------------
    def open_session(self, nonce=None) -> StreamSession:
        return self.batch.add_session(nonce)

    def pending_lanes(self) -> int:
        """Lanes submitted but not yet materialized (buffered + in-flight)."""
        return self._buffered + self._inflight

    def busy(self) -> bool:
        """Whether eviction/teardown would lose work: lanes pending or
        completed responses not yet collected."""
        with self._lock:
            return self.pending_lanes() > 0 or bool(self._completed)

    def warmup(self):
        """Run one dummy window before taking traffic (re-deriving session
        0's counter 0 — consumes no counters), so the kernel library is
        built and loaded and the allocator holds window-sized blocks."""
        if not self.batch.sessions:
            raise RuntimeError("open a session before warmup")
        plan = WindowPlan(np.zeros(self.window, np.int64),
                          np.zeros(self.window, np.int64))
        self.farm.run_one(plan).cpu()

    # ------------------------------------------------------------------
    def submit(self, req: HHERequest) -> Optional[np.ndarray]:
        """Admit + queue a request; counters are reserved immediately (the
        client learns them synchronously and can pre-share them).  Returns
        the reserved counters, or None when the request was shed.  If the
        request fills one or more windows and ``fire_on_fill`` is set,
        they dispatch before submit returns — the submit IS the wake-up
        event."""
        with self._lock:
            entry = self.submit_entry(req)
            return None if entry is None else entry.ctrs

    def submit_entry(self, req: HHERequest) -> Optional[_Entry]:
        """submit(), but returns the internal entry (the async front end
        correlates responses by ``entry.seq``)."""
        with self._lock:
            if not 0 <= req.session_id < len(self.batch.sessions):
                raise KeyError(
                    f"unknown session {req.session_id} (pool has "
                    f"{len(self.batch.sessions)}; open_session() first)"
                )
            # admission control BEFORE any counter reservation: a shed or
            # rejected request must leave no trace in the counter space
            if (self.max_pending_lanes is not None
                    and self.pending_lanes() + req.blocks
                    > self.max_pending_lanes):
                if self.overload == "shed":
                    self.shed_count += 1
                    return None
                self.rejected_count += 1
                raise HHEServerSaturated(
                    f"pending lanes {self.pending_lanes()} + {req.blocks} "
                    f"exceed max_pending_lanes={self.max_pending_lanes}; "
                    "back off and retry")
            sess = self.batch.sessions[req.session_id]
            # fresh-session space, via the cursor so a monkeypatched
            # SESSION_CTR_LIMIT (tests) is honored
            capacity = sess.next_ctr + sess.remaining()
            # Auto-rotation is only sound for server-originated keystream:
            # decrypt payloads are bound to the OLD (nonce, counter) space,
            # so rotating would subtract fresh-nonce keystream and return
            # garbage — for those, fall through and let take_window refuse
            # loudly.
            if (self.auto_rotate and req.blocks > sess.remaining()
                    and req.op not in ("decrypt", "decrypt_tokens")
                    and req.blocks <= capacity):
                # old-nonce lanes must materialize before the table row is
                # replaced — rotation is a materialization boundary; the
                # forced responses surface via flush()/pop_completed()
                self._fire_full()
                self._fire_partial()
                self._drain()
                sess = self.batch.rotate_session(req.session_id)
            ctrs = sess.take_window(req.blocks)
            entry = _Entry(
                seq=self._seq, req=req, ctrs=ctrs,
                t_submit=time.perf_counter(),
                rows=np.empty((req.blocks, self.batch.params.l), np.uint32),
                remaining=req.blocks,
                nonce=bytes(sess.nonce), generation=sess.generation,
            )
            self._seq += 1
            self._frags.append([entry, ctrs.astype(np.int64), 0])
            self._buffered += req.blocks
            if self.fire_on_fill:
                self._fire_full()
            return entry

    # ------------------------------------------------------------------
    # window carving and firing
    # ------------------------------------------------------------------
    def _carve(self, count: int) -> WindowPlan:
        """Pop ``count`` buffered lanes into one WindowPlan (padded via
        pack_windows when part-full), tagging per-lane owners in meta."""
        sids = np.empty(count, np.int64)
        ctrs = np.empty(count, np.int64)
        owners = []
        filled = 0
        while filled < count:
            frag = self._frags[0]
            entry, ectrs, off = frag
            take = min(count - filled, ectrs.shape[0] - off)
            sids[filled:filled + take] = entry.req.session_id
            ctrs[filled:filled + take] = ectrs[off:off + take]
            owners.extend((entry, off + j) for j in range(take))
            filled += take
            if off + take == ectrs.shape[0]:
                self._frags.popleft()
            else:
                frag[2] = off + take
        self._buffered -= count
        (plan,) = pack_windows(sids, ctrs, self.window)
        plan.meta = owners
        return plan

    def _push(self, plan: WindowPlan) -> None:
        plan.t_push = time.perf_counter()
        self._inflight += plan.valid
        self._pending_windows.append(plan)
        for p, z in self._pipe.push(plan):
            self._materialize(p, z)

    def _fire_full(self) -> int:
        """Dispatch every FULL buffered window (the fill event)."""
        fired = 0
        while self._buffered >= self.window:
            self._push(self._carve(self.window))
            self.fill_fires += 1
            fired += 1
        return fired

    def _fire_partial(self) -> bool:
        """Dispatch the part-full tail window, padded (deadline/flush/
        rotation edges).  No-ops when nothing is buffered — the empty-
        window dispatch the old pull loop could make is structurally
        impossible here."""
        if not self._buffered:
            return False
        self._push(self._carve(self._buffered))
        return True

    def _drain(self) -> None:
        for p, z in self._pipe.drain():
            self._materialize(p, z)

    def _materialize(self, plan: WindowPlan, z) -> None:
        z = z.cpu().numpy().astype(np.uint32)
        t_now = time.perf_counter()
        self.window_latencies.append(t_now - plan.t_push)
        self._pending_windows.popleft()
        self._inflight -= plan.valid
        self.windows_served += 1
        for j in range(plan.valid):
            entry, row = plan.meta[j]
            entry.rows[row] = z[j]
            entry.remaining -= 1
            if entry.remaining == 0:
                self._completed.append(self._respond(entry, t_now))

    def _respond(self, entry: _Entry, t_done: float) -> HHEResponse:
        req, z = entry.req, torch.as_tensor(entry.rows.astype(np.int64))
        mod = self.batch.params.mod
        if req.op == "keystream":
            result = entry.rows
        elif req.op == "encrypt":
            result = encrypt_fixed(mod, req.payload, z,
                                   req.delta).numpy().astype(np.uint32)
        elif req.op == "encrypt_tokens":        # exact Z_q, no encoding
            result = add_words(mod, as_int64(req.payload, "cpu"),
                               z).numpy().astype(np.uint32)
        elif req.op == "decrypt_tokens":
            result = sub_words(mod, as_int64(req.payload, "cpu"),
                               z).numpy().astype(np.int32)
        else:  # decrypt
            result = decrypt_fixed(mod, req.payload, z, req.delta).numpy()
        lat = t_done - entry.t_submit
        self.latencies.append(lat)
        return HHEResponse(request=req, result=result,
                           block_ctrs=entry.ctrs, latency_s=lat,
                           seq=entry.seq)

    # ------------------------------------------------------------------
    # scheduler edges
    # ------------------------------------------------------------------
    def _oldest_pending_t(self) -> Optional[float]:
        if self._pending_windows:
            return self._pending_windows[0].meta[0][0].t_submit
        if self._frags:
            return self._frags[0][0].t_submit
        return None

    def next_due(self) -> Optional[float]:
        """perf_counter() time the deadline edge next trips, or None."""
        with self._lock:
            if self.deadline_s is None:
                return None
            t = self._oldest_pending_t()
            return None if t is None else t + self.deadline_s

    def service(self, now: Optional[float] = None) -> List[HHEResponse]:
        """The timer edge: fire any full windows (for schedulers running
        with ``fire_on_fill=False``), then — if the oldest un-materialized
        lane is older than ``deadline_s`` — fire the part-full window and
        drain the pipeline so everything pending lands.  Returns newly
        completed responses (submission-ordered)."""
        with self._lock:
            self._fire_full()
            if self.deadline_s is not None:
                t = self._oldest_pending_t()
                now = time.perf_counter() if now is None else now
                if t is not None and now - t >= self.deadline_s:
                    self._fire_partial()
                    self._drain()
                    self.deadline_fires += 1
            return self.pop_completed()

    def flush(self) -> List[HHEResponse]:
        """Force everything pending through the farm; returns responses in
        submission order (including any materialized early by fill or
        deadline fires).  Short-circuits the window dispatch when no lanes
        are pending — a drained server never runs an empty window."""
        with self._lock:
            self.quiesce()
            return self.pop_completed()

    def quiesce(self) -> None:
        """Materialize everything pending WITHOUT collecting responses —
        they stay queued for the next pop_completed()/flush().  The
        rotation/eviction boundary for callers that don't own response
        delivery."""
        with self._lock:
            if self._buffered:
                self._fire_full()
                self._fire_partial()
            self._drain()

    def pop_completed(self) -> List[HHEResponse]:
        """Collect responses completed since the last collection, in
        submission order."""
        with self._lock:
            out, self._completed = self._completed, []
            out.sort(key=lambda r: r.seq)
            return out

    # ------------------------------------------------------------------
    def latency_stats(self) -> dict:
        """Always fully populated — zeroed percentiles before any window
        has served (the empty-percentile crash is gone), plus scheduler/
        admission counters."""
        with self._lock:
            stats = {"count": 0, "p50_ms": 0.0, "p99_ms": 0.0,
                     "mean_ms": 0.0}
            if self.latencies:
                lat = np.asarray(self.latencies)
                stats = {
                    "count": int(lat.size),
                    "p50_ms": float(np.percentile(lat, 50) * 1e3),
                    "p99_ms": float(np.percentile(lat, 99) * 1e3),
                    "mean_ms": float(lat.mean() * 1e3),
                }
            stats.update(
                queue_depth_lanes=self._buffered,
                inflight_lanes=self._inflight,
                windows_served=self.windows_served,
                fill_fires=self.fill_fires,
                deadline_fires=self.deadline_fires,
                shed=self.shed_count,
                rejected=self.rejected_count,
            )
            return stats
