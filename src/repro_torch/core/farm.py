"""Multi-stream keystream farm: depth-configurable producer→consumer windows.

The port's copy of `repro.core.farm`.  A *window* is a fixed-size batch of
lanes, each an arbitrary (session, block-counter) pair of one
:class:`CipherBatch` pool.  :class:`KeystreamFarm` runs windows through a
FIFO of configurable ``depth``: producers for up to ``depth-1`` windows
ahead are dispatched before window i's consumer runs.  ``matrix_depth``
adds a second FIFO that produces PASTA's heavy matrix plane further ahead.

Overlap.  The reference gets producer/consumer overlap from JAX's async
dispatch.  Here, on a CUDA device, every produce runs on one side
``torch.cuda.Stream`` and records an event; the consumer's stream waits on
that event before reading the window's planes, and the planes are
``record_stream``-ed onto the consumer's stream so the caching allocator
cannot hand their memory out early.  On the CPU everything runs in order.
FIFO order and bytes are identical at every depth and matrix_depth.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.cipher import (
    CipherBatch,
    decrypt_fixed,
    encrypt_fixed,
)
from repro_torch.core.engine import EngineSpec


@dataclasses.dataclass
class WindowPlan:
    """One farm step: parallel per-lane (session, counter) arrays.

    ``valid`` counts the real lanes; lanes past it are padding (repeats of
    the last real lane, discarded on trim)."""

    session_ids: np.ndarray   # (lanes,) int32
    block_ctrs: np.ndarray    # (lanes,) uint32
    meta: Any = None          # opaque caller tag (e.g. request slices)
    valid: Optional[int] = None

    def __post_init__(self):
        self.session_ids = np.asarray(self.session_ids, np.int32).reshape(-1)
        self.block_ctrs = np.asarray(self.block_ctrs, np.uint32).reshape(-1)
        if self.session_ids.shape != self.block_ctrs.shape:
            raise ValueError("session_ids / block_ctrs length mismatch")
        if self.valid is None:
            self.valid = self.session_ids.shape[0]
        if not 0 < self.valid <= self.session_ids.shape[0]:
            raise ValueError(
                f"valid={self.valid} out of range for "
                f"{self.session_ids.shape[0]} lanes")

    @property
    def lanes(self) -> int:
        return self.session_ids.shape[0]


def pack_windows(session_ids, block_ctrs, window: int) -> List[WindowPlan]:
    """Per-lane arrays -> fixed-size `WindowPlan`s; a ragged tail is padded
    by repeating its last real lane, ``valid`` marking the real ones."""
    if window <= 0:
        raise ValueError("window must be positive")
    sids = np.asarray(session_ids).reshape(-1)
    ctrs = np.asarray(block_ctrs).reshape(-1)
    if sids.shape != ctrs.shape:
        raise ValueError("session_ids / block_ctrs length mismatch")
    plans = []
    for i in range(0, sids.shape[0], window):
        s, c = sids[i : i + window], ctrs[i : i + window]
        valid = s.shape[0]
        if valid < window:
            pad = window - valid
            s = np.concatenate([s, np.full(pad, s[-1], s.dtype)])
            c = np.concatenate([c, np.full(pad, c[-1], c.dtype)])
        plans.append(WindowPlan(s, c, valid=valid))
    return plans


def plan_windows(sessions, blocks_per_session: int, window: int,
                 interleave: bool = True) -> List[WindowPlan]:
    """Reserve ``blocks_per_session`` counters on each session and pack the
    lanes into fixed-size windows (interleave=True round-robins sessions
    across lanes; False keeps each session's lanes contiguous)."""
    pairs = []
    for s in sessions:
        ctrs = s.take_window(blocks_per_session)
        pairs.append(np.stack(
            [np.full(blocks_per_session, s.index, np.int64), ctrs]))
    stacked = np.stack(pairs)                     # (S, 2, B)
    if interleave:
        flat = stacked.transpose(2, 0, 1).reshape(-1, 2)   # ctr-major
    else:
        flat = stacked.transpose(0, 2, 1).reshape(-1, 2)   # session-major
    return pack_windows(flat[:, 0], flat[:, 1], window)


class _Produced:
    """A window's constants in flight, with the event that marks them
    ready on the producer's stream (None on the CPU)."""

    def __init__(self, consts: dict, event):
        self.consts = consts
        self.event = event

    def ready(self) -> dict:
        """Make the current stream wait for the planes and keep their
        memory alive until the current stream is done with them."""
        if self.event is not None:
            cur = torch.cuda.current_stream()
            cur.wait_event(self.event)
            for t in self.consts.values():
                if t is not None:
                    t.record_stream(cur)
        return self.consts


class KeystreamFarm:
    """Depth-configurable producer→consumer pipeline over a CipherBatch.

    ``engine``: any registered engine name, "auto" (``cuda`` on a CUDA
    pool, ``ref`` on a CPU pool) or a bound engine instance; ``devices``
    names the devices the ``sharded`` engine splits each window's lanes
    over (the reference's ``mesh``).  ``depth`` is
    the producer→consumer FIFO depth (2 = double buffering, 1 =
    serialized).  ``matrix_depth >= 2`` produces the matrix plane of
    stream-matrix presets (PASTA) up to that many windows ahead through a
    second FIFO.

    ``plan`` applies a measured :class:`repro_torch.core.tuner.StreamPlan`
    in one shot: producer (rebound on the pool), engine, variant, depth,
    matrix_depth and reduction mode, with any argument passed explicitly
    taking precedence; its window becomes :attr:`window`.
    """

    def __init__(self, batch: CipherBatch, engine: Optional[EngineSpec] = None,
                 *, devices=None, variant: Optional[str] = None,
                 depth: Optional[int] = None,
                 matrix_depth: Optional[int] = None,
                 reduction: Optional[str] = None, plan=None):
        self.plan = plan
        self.window: Optional[int] = None
        if plan is not None:
            if engine is None:
                engine = plan.engine
            if variant is None:
                variant = plan.variant
            if depth is None:
                depth = plan.depth
            if matrix_depth is None:
                matrix_depth = plan.matrix_depth
            if reduction is None:
                reduction = plan.reduction
            self.window = plan.window
            batch.set_producer(plan.producer)
        depth = 2 if depth is None else int(depth)
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1 (got {depth})")
        self.depth = depth
        matrix_depth = 1 if matrix_depth is None else int(matrix_depth)
        if matrix_depth < 1:
            raise ValueError(
                f"matrix prefetch depth must be >= 1 (got {matrix_depth})")
        self.matrix_depth = matrix_depth
        self.batch = batch
        self.engine = batch.make_engine("auto" if engine is None else engine,
                                        devices=devices, variant=variant,
                                        reduction=reduction)
        self._stream = (torch.cuda.Stream(device=batch.device)
                        if batch.device.type == "cuda" else None)
        self._synced_tables = None

    @property
    def _splits_planes(self) -> bool:
        return (self.matrix_depth > 1
                and self.batch.params.n_matrix_constants > 0)

    # ------------------------------------------------------------------
    def _dispatch(self, plan: WindowPlan, plane: str) -> _Produced:
        with obs.span("farm.produce"):
            tables = self.batch.xof_tables()
            if self._stream is None:
                return _Produced(self.batch.producer.produce(
                    tables, plan.session_ids, plan.block_ctrs, plane), None)
            if tables is not self._synced_tables:
                # fresh session tables were uploaded on the caller's stream
                self._stream.wait_stream(torch.cuda.current_stream())
                self._synced_tables = tables
            with torch.cuda.stream(self._stream):
                for t in tables.device:
                    t.record_stream(self._stream)
                consts = self.batch.producer.produce(
                    tables, plan.session_ids, plan.block_ctrs, plane)
                event = torch.cuda.Event()
                event.record(self._stream)
            return _Produced(consts, event)

    def produce(self, plan: WindowPlan, plane: str = "all") -> _Produced:
        """Dispatch the producer for one window (on the side stream on a
        CUDA pool)."""
        return self._dispatch(plan, plane)

    def produce_matrix(self, plan: WindowPlan) -> _Produced:
        """Dispatch matrix-plane-only production for one window."""
        return self._dispatch(plan, "matrix")

    def consume(self, constants):
        """Run the engine on produced constants (a `produce` result or a
        plain constants dict)."""
        with obs.span("farm.consume"):
            if isinstance(constants, _Produced):
                constants = constants.ready()
            return self.engine(constants)

    # ------------------------------------------------------------------
    def pipeline(self) -> "FarmPipeline":
        """A stateful push/drain view of the producer→consumer FIFO."""
        return FarmPipeline(self)

    def run(self, plans: Iterable[WindowPlan]
            ) -> Iterator[Tuple[WindowPlan, torch.Tensor]]:
        """Yield (plan, keystream) per window, pipeline-depth buffered."""
        pipe = self.pipeline()
        for plan in plans:
            yield from pipe.push(plan)
        yield from pipe.drain()

    def run_one(self, plan: WindowPlan) -> torch.Tensor:
        """Serialized single-window convenience: produce + consume now."""
        return self.consume(self.produce(plan))

    def keystream(self, session_ids, block_ctrs, window: Optional[int] = None):
        """Full keystream for per-lane pairs, windowed (by the plan's window
        when one was applied and ``window`` is None, else as one window);
        lane order kept."""
        sid = np.asarray(session_ids, np.int64).reshape(-1)
        ctr = np.asarray(block_ctrs, np.int64).reshape(-1)
        if window is None:
            window = self.window or sid.shape[0]
        plans = pack_windows(sid, ctr, window)
        outs = [z[: p.valid] for p, z in self.run(plans)]
        return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]

    # ------------------------------------------------------------------
    def _payload_stream(self, plans_and_payloads):
        payloads: deque = deque()

        def plans():
            for plan, payload in plans_and_payloads:
                payloads.append(payload)
                yield plan

        for plan, z in self.run(plans()):
            yield plan, payloads.popleft(), z

    def encrypt_stream(self, plans_and_msgs, delta: float = 1024.0):
        """Iterable of (WindowPlan, (lanes, l) float) -> (plan, ciphertext)."""
        mod = self.batch.params.mod
        for plan, m, z in self._payload_stream(plans_and_msgs):
            with obs.span("farm.encrypt"):
                ct = encrypt_fixed(mod, m, z, delta)
            yield plan, ct

    def decrypt_stream(self, plans_and_cts, delta: float = 1024.0):
        """Iterable of (WindowPlan, (lanes, l) ints) -> (plan, float32)."""
        mod = self.batch.params.mod
        for plan, ct, z in self._payload_stream(plans_and_cts):
            yield plan, decrypt_fixed(mod, ct, z, delta)


class FarmPipeline:
    """Incremental (push-driven) form of :meth:`KeystreamFarm.run`:
    ``push(plan)`` dispatches the window's producer(s) now and returns the
    (plan, keystream) pairs whose consumers fired as the FIFO reached its
    depth; ``drain()`` finishes everything in flight.  Push-then-drain
    reproduces ``run()``'s dispatch order exactly."""

    def __init__(self, farm: KeystreamFarm):
        self.farm = farm
        self._fifo: deque = deque()     # (plan, produced[, produced mats])
        self._mfifo: deque = deque()    # (plan, produced matrix plane)

    def in_flight(self) -> int:
        """Windows dispatched (producer running) but not yet consumed."""
        return len(self._fifo) + len(self._mfifo)

    def _promote(self) -> None:
        plan, mats = self._mfifo.popleft()
        self._fifo.append((plan, self.farm.produce(plan, "vector"), mats))

    def _consume_one(self):
        entry = self._fifo.popleft()
        if len(entry) == 3:
            plan, consts, mats = entry
            merged = dict(consts.ready())
            merged["mats"] = mats.ready()["mats"]
            return plan, self.farm.consume(merged)
        plan, consts = entry
        return plan, self.farm.consume(consts)

    def push(self, plan: WindowPlan) -> List[Tuple[WindowPlan, torch.Tensor]]:
        out: List[Tuple[WindowPlan, torch.Tensor]] = []
        if self.farm._splits_planes:
            self._mfifo.append((plan, self.farm.produce_matrix(plan)))
            if len(self._mfifo) >= self.farm.matrix_depth:
                self._promote()
        else:
            self._fifo.append((plan, self.farm.produce(plan)))
        while len(self._fifo) >= self.farm.depth:
            out.append(self._consume_one())
        return out

    def drain(self) -> List[Tuple[WindowPlan, torch.Tensor]]:
        out: List[Tuple[WindowPlan, torch.Tensor]] = []
        while self._mfifo:
            self._promote()
            while len(self._fifo) >= self.farm.depth:
                out.append(self._consume_one())
        while self._fifo:
            out.append(self._consume_one())
        return out
