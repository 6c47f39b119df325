"""The bulk loop: a gateway encrypts one CKKS vector from each of its
clients a job, through `KeystreamFarm.encrypt_stream`.

A job is one window: ``clients`` sessions of ceil(slots / l) blocks
each, a client's blocks side by side. A closed loop keeps the farm's
depth of jobs outstanding: it plans job i while earlier jobs run (each
session reserves its counters, `StreamSession.take_window`, and the
gateway lays them into a `WindowPlan`), then waits until job i - depth
has completed, the moment its ciphertext is ready on the device (a CUDA
event recorded after it), and pushes job i. A job's latency runs from
its push to its completion, stamped at the first of the loop's looks
at its event that finds it complete: before and after planning each
job, after each ciphertext the farm hands back, and while it waits on
the oldest job. A client's counters advance job by job; when
its nonce has no room for another vector the gateway rotates the session
to a fresh nonce. The clients start at staggered counters, as clients
that joined at different times would, so each job rotates about as many
sessions as any other. Messages are float32 made on the device from the
seed (a pool of ``message_pool`` job-sized tensors, job i taking entry i
mod the pool); the ciphertext stays on the device.

Correct: the reference recomputes ``check_jobs`` whole jobs drawn from
the seed among the first ``check_jobs_from`` and the window's last job,
and ``check_lanes_per_job`` lanes of every job of the window, drawn from
the seed, which the loop gathers on the device as each job finishes.
"""

from __future__ import annotations

import math
import time
from collections import deque

import numpy as np

from hhebench.harness import (
    CTR_LIMIT,
    Cell,
    NonceBook,
    Outcome,
    check_params,
    percentile,
    torch_generator,
)
from hhebench.reference import cipher as ref
from hhebench.trace import Spans, capture

SAMPLE_ROWS = 4096


class _Gateway:
    def __init__(self, cell: Cell):
        import torch

        from repro_torch.core.cipher import CipherBatch
        from repro_torch.core.farm import KeystreamFarm

        cfg, tr, dev = cell.cfg, cell.traffic, cell.device
        self.cell, self.dev = cell, dev
        rng = np.random.default_rng(cell.seed)
        self.key = rng.integers(1, cfg["q"], size=cfg["n"], dtype=np.int64)
        self.book = NonceBook(rng)
        gen = torch_generator(rng, dev)
        self.batch = CipherBatch(cfg["cipher"], key=self.key,
                                 producer=cfg["producer"], device=dev)
        check_params(self.batch.params, cfg)
        self.farm = KeystreamFarm(self.batch, engine=cfg["engine"],
                                  variant=cfg["variant"], depth=cfg["depth"],
                                  reduction=cfg["reduction"])
        self.clients = tr["clients"]
        self.blocks = math.ceil(tr["slots"] / cfg["l"])
        self.lanes = self.clients * self.blocks
        self.session_ids = np.repeat(np.arange(self.clients, dtype=np.int32),
                                     self.blocks)
        self.nonce_of = np.zeros(self.clients, np.int64)
        self.cursor = np.zeros(self.clients, np.int64)
        per_nonce = CTR_LIMIT // self.blocks
        for c in range(self.clients):
            self.nonce_of[c] = self.book.new()
            s = self.batch.add_session(nonce=self.book[self.nonce_of[c]])
            if c % per_nonce:
                s.take_window((c % per_nonce) * self.blocks)
                self.cursor[c] = (c % per_nonce) * self.blocks
        a = float(tr["message_abs_max"])
        self.pool = [(torch.rand(self.lanes, cfg["l"], generator=gen,
                                 device=dev) * 2 - 1) * a
                     for _ in range(tr["message_pool"])]
        k = tr["check_lanes_per_job"]
        self.sample_idx = torch.randint(0, self.lanes, (SAMPLE_ROWS, k),
                                        generator=gen, device=dev)
        self.sample_host = self.sample_idx.cpu().numpy()
        self.full_jobs = set(int(j) for j in rng.choice(
            tr["check_jobs_from"], size=tr["check_jobs"], replace=False))
        # per job: (nonce index per client, first counter per client)
        self.jobs = []
        self.t_push, self.t_done = {}, {}
        self.samples, self.kept = {}, {}
        self.wrong_counters = 0
        self.pending = deque()
        self.done = 0
        self.window_first = 0               # the measured window's first job
        self.plan_s = self.wait_s = 0.0     # host seconds, for the log

    # --- one job ------------------------------------------------------
    def _job(self, i: int):
        from repro_torch.core.farm import WindowPlan

        for c in range(self.clients):
            if self.cursor[c] + self.blocks > CTR_LIMIT:
                self.nonce_of[c] = self.book.new()
                self.batch.rotate_session(c, nonce=self.book[self.nonce_of[c]])
                self.cursor[c] = 0
        self.jobs.append((self.nonce_of.copy(), self.cursor.copy()))
        ctrs = np.concatenate([s.take_window(self.blocks)
                               for s in self.batch.sessions])
        lanes = self.sample_host[i % SAMPLE_ROWS]
        self.wrong_counters += int(np.count_nonzero(
            ctrs[lanes] != self.lane_pairs(i, lanes)[1]))
        self.cursor += self.blocks
        return WindowPlan(self.session_ids, ctrs, meta=i)

    def lane_pairs(self, i: int, lanes):
        """(nonce index, block counter) of lanes of job i, as the gateway's
        own books have them: client-major, a client's blocks in order."""
        nonce_of, first = self.jobs[i]
        c = lanes // self.blocks
        return nonce_of[c], first[c] + lanes % self.blocks

    def _stamp(self, i: int):
        self.t_done[i] = time.perf_counter()
        self.done += 1

    def _poll(self):
        """Stamp every pending job whose event reports complete, oldest
        first: one stream completes them in order."""
        while self.pending and (self.pending[0][1] is None
                                or self.pending[0][1].query()):
            self._stamp(self.pending.popleft()[0])

    def _complete_oldest(self):
        i, ev = self.pending.popleft()
        if ev is not None:
            ev.synchronize()
        self._stamp(i)

    def stream(self, first: int, stop, spans: Spans, record: bool) -> int:
        """Push jobs first, first + 1, ... until ``stop(i)``, through
        `encrypt_stream`; return the next job's index."""
        import torch

        cuda = self.dev.type == "cuda"
        nxt = [first]

        def jobs():
            i = first
            while not stop(i):
                # the next job is planned while the ones in flight run
                self._poll()
                t0 = time.perf_counter()
                with spans("hhebench.plan"):
                    plan = self._job(i)
                t1 = time.perf_counter()
                self._poll()
                with spans("hhebench.wait"):
                    while i - self.done >= self.farm.depth:
                        self._complete_oldest()
                self.t_push[i] = time.perf_counter()
                self.plan_s += t1 - t0
                self.wait_s += self.t_push[i] - t1
                yield plan, self.pool[i % len(self.pool)]
                i += 1
            nxt[0] = i

        last = None
        delta = self.cell.traffic["delta"]
        for plan, ct in self.farm.encrypt_stream(jobs(), delta):
            i = plan.meta
            with spans("hhebench.sample"):
                if record:
                    self.samples[i] = ct.index_select(
                        0, self.sample_idx[i % SAMPLE_ROWS])
                    if i - self.window_first in self.full_jobs:
                        self.kept[i] = ct
                    last = (i, ct)
                ev = None
                if cuda:
                    ev = torch.cuda.Event()
                    ev.record()
            self.pending.append((i, ev))
            self._poll()
        with spans("hhebench.wait"):
            while self.pending:
                self._complete_oldest()
        if record and last is not None:
            self.kept[last[0]] = last[1]
        return nxt[0]

    # --- the check ----------------------------------------------------
    def check(self, control):
        """(words that differ from the reference's, jobs holding any) over
        the window's whole jobs and lane samples."""
        import torch

        cfg, dev, q = self.cell.cfg, self.dev, self.cell.cfg["q"]
        delta = self.cell.traffic["delta"]
        ks = ref.Keystream(cfg, self.key, dev)
        tables = ks.tables(self.book.array())
        wrong, bad = 0, set()

        def compare(i, lanes, msg, got):
            nonce, ctr = self.lane_pairs(i, lanes)
            z = ks.keystream(tables, torch.as_tensor(nonce, device=dev),
                             torch.as_tensor(ctr, device=dev))
            want = ref.encrypt(msg, z, delta, q)
            if control == "bf16":
                got = ref.encrypt(msg, z, delta, q, torch.bfloat16)
            n = int((got.to(torch.int64) != want).sum())
            if n:
                bad.add(i)
            return n

        every = np.arange(self.lanes)
        for i, ct in sorted(self.kept.items()):
            wrong += compare(i, every, self.pool[i % len(self.pool)], ct)
        for i, got in sorted(self.samples.items()):
            row = i % SAMPLE_ROWS
            msg = self.pool[i % len(self.pool)][self.sample_idx[row]]
            wrong += compare(i, self.sample_host[row], msg, got)
        return wrong, len(bad)


def run(cell: Cell) -> Outcome:
    import torch

    t0 = time.perf_counter()
    g = _Gateway(cell)
    dev, tr = cell.device, cell.traffic
    off = Spans(False)
    t_built = time.perf_counter()
    # set-up: the cell's own shapes, through the same loop
    first = g.stream(0, lambda i: i >= tr["warm_jobs"], off, record=False)
    g.window_first = first
    t_start = time.perf_counter()
    setup_s = t_start - cell.t_process
    g.plan_s = g.wait_s = 0.0
    end = g.stream(first, lambda i: time.perf_counter() - t_start
                   >= cell.seconds, off, record=True)
    window = range(first, end)
    t_end = max(g.t_done[i] for i in window)
    lat = [(g.t_done[i] - g.t_push[i]) * 1e3 for i in window]
    words = len(window) * g.lanes * cell.cfg["l"]
    host = {"keystream_words_per_s": words / (t_end - t_start),
            "job_p99_ms": percentile(lat, 99),
            "job_p95_ms": percentile(lat, 95),
            "job_p50_ms": percentile(lat, 50),
            "jobs": len(window),
            "plan_ms_per_job": g.plan_s / len(window) * 1e3,
            "wait_ms_per_job": g.wait_s / len(window) * 1e3,
            "setup_build_s": t_built - t0, "setup_warm_s": t_start - t_built}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace = None
    if cell.trace:
        def traced(spans):
            stop = end + tr["trace_jobs"]
            g.stream(end, lambda i: i >= stop, spans, record=False)
            return tr["trace_jobs"], tr["trace_jobs"] * g.lanes
        trace = capture(traced, dev, "farm.encrypt_stream")
    missing = sum(1 for i in window if i not in g.t_done)
    # the program's state goes before the reference runs
    g.farm = g.batch = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    wrong, bad = g.check(cell.control)
    checks = {"wrong_words": (wrong, 0),
              "wrong_counters": (g.wrong_counters, 0),
              "missing_jobs": (missing, 0)}
    failed = missing + bad
    return Outcome(setup_s, host, len(window), failed, checks, peak, trace)
