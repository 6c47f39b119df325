"""Measured StreamPlan autotuner: producer × engine × variant × window ×
depth × matrix_depth × reduction.

The port's copy of `repro.core.tuner`.  Every pipeline tuple is timed on
the real :class:`KeystreamFarm` loop (the dispatch pattern serving runs),
the winner by per-window p50 is persisted to a JSON cache keyed by
(preset, lanes, noise, host and device fingerprint), and "auto"
resolution (`core/engine.py` `resolve_engine`, `core/producer.py`
`resolve_producer`) consults it.

  * :class:`StreamPlan` — one immutable pipeline configuration.
  * :func:`autotune` — measure every candidate, persist and return the
    winner (a cache hit returns the persisted plan without timing).
  * :func:`load_plan` — the cheap cache-only lookup.

Candidates are stream-preserving by construction (only producers whose
XOF stream matches ``params.xof``), and every engine × variant ×
reduction is bit-exact, so a tuned plan changes latency, never a
keystream bit.

    PYTHONPATH=src python -m repro_torch.core.tuner            # tables
    PYTHONPATH=src python -m repro_torch.core.tuner --autotune \\
        --preset hera-128a --lanes 4096                         # measure

The cache lives at ``$REPRO_TORCH_TUNER_CACHE`` (or
``~/.cache/repro-presto/streamplans-torch.json``): a file of its own, so
the port and the JAX tuner never share an entry — their engines, their
timings and their semantics differ.  A plan is scoped to the device it
was measured on: one timed on the CPU never steers the card, nor the
reverse.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import platform
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.cipher import CipherBatch
from repro_torch.core.engine import ORACLES, engine_caps
from repro_torch.core.farm import KeystreamFarm, pack_windows
from repro_torch.core.params import CipherParams, get_params
from repro_torch.core.producer import compatible_producers, producer_caps
from repro_torch.core.redplan import REDUCTION_MODES
from repro_torch.device import resolve_device

CACHE_VERSION = 1
#: Per-entry plan schema, the reference's history (4 = reduction mode as
#: a measured dimension).  Bump when a backend changes semantics under an
#: unchanged name, so an old measurement cannot steer the new code.
PLAN_SCHEMA = 4
_ENV_CACHE = "REPRO_TORCH_TUNER_CACHE"


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """One pipeline configuration — the autotuner's unit of selection.

    Round-trips through JSON bit-identically (`to_json`/`from_json`);
    unknown keys on load are ignored, so cache entries carry measurement
    metadata beside the plan.
    """

    producer: str      # repro_torch.core.producer backend name
    engine: str        # repro_torch.core.engine backend name
    variant: str       # schedule orientation (core/schedule.py)
    window: int        # lanes per farm window
    depth: int         # producer->consumer FIFO depth (farm)
    matrix_depth: int = 1  # matrix-plane prefetch depth (farm; PASTA only)
    reduction: str = "lazy"  # reduction-scheduling mode (core/redplan.py)

    def to_json(self) -> dict:
        return {
            "producer": self.producer,
            "engine": self.engine,
            "variant": self.variant,
            "window": int(self.window),
            "depth": int(self.depth),
            "matrix_depth": int(self.matrix_depth),
            "reduction": self.reduction,
        }

    @classmethod
    def from_json(cls, d: dict) -> "StreamPlan":
        return cls(
            producer=str(d["producer"]),
            engine=str(d["engine"]),
            variant=str(d["variant"]),
            window=int(d["window"]),
            depth=int(d["depth"]),
            matrix_depth=int(d.get("matrix_depth", 1)),
            reduction=str(d.get("reduction", "lazy")),
        )

    def describe(self) -> str:
        return (f"producer={self.producer} engine={self.engine} "
                f"variant={self.variant} window={self.window} "
                f"depth={self.depth} matrix_depth={self.matrix_depth} "
                f"reduction={self.reduction}")


# ==========================================================================
# Cache: JSON keyed by (preset, lanes, noise, host and device fingerprint)
# ==========================================================================
def host_fingerprint(device=None) -> str:
    """Stable id for "this machine, this device": a plan measured on one
    must not steer another (the tuner's answer is hardware-shaped)."""
    dev = resolve_device(device)
    parts = [platform.machine(), platform.system(), dev.type,
             torch.__version__, str(torch.version.cuda), str(os.cpu_count())]
    if dev.type == "cuda":
        parts += [torch.cuda.get_device_name(dev),
                  str(torch.cuda.device_count())]
    return hashlib.sha1("|".join(parts).encode()).hexdigest()[:12]


def cache_key(params: CipherParams, lanes: Optional[int], device=None) -> str:
    return (f"{params.name}|lanes={lanes}|noise={params.n_noise}"
            f"|host={host_fingerprint(device)}")


def default_cache_path() -> pathlib.Path:
    env = os.environ.get(_ENV_CACHE)
    if env:
        return pathlib.Path(env)
    return (pathlib.Path.home() / ".cache" / "repro-presto"
            / "streamplans-torch.json")


def _cache_path(cache_path) -> pathlib.Path:
    return pathlib.Path(cache_path) if cache_path else default_cache_path()


def _read_cache(path: pathlib.Path) -> dict:
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {"version": CACHE_VERSION, "plans": {}}
    if not isinstance(data, dict) or data.get("version") != CACHE_VERSION \
            or not isinstance(data.get("plans"), dict):
        return {"version": CACHE_VERSION, "plans": {}}
    return data


def _write_cache(path: pathlib.Path, data: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def _coerce_params(params: Union[CipherParams, str]) -> CipherParams:
    return get_params(params) if isinstance(params, str) else params


def _plan_is_valid(plan: StreamPlan, params: CipherParams,
                   device: torch.device) -> bool:
    """A cached plan is trusted only if every named backend still exists,
    is available, runs on ``device``, and preserves the preset's stream."""
    pcaps = producer_caps().get(plan.producer)
    if pcaps is None or not pcaps.available:
        return False
    if pcaps.stream not in (None, params.xof):
        return False
    ecaps = engine_caps().get(plan.engine)
    if ecaps is None or not ecaps.available \
            or device.type not in ecaps.device_types:
        return False
    if plan.variant not in ecaps.schedule_variants:
        return False
    if plan.reduction not in REDUCTION_MODES:
        return False
    return (plan.window >= 1 and plan.depth >= 1
            and plan.matrix_depth >= 1)


def save_plan(params: Union[CipherParams, str], lanes: int, plan: StreamPlan,
              p50_ms: float, cache_path=None,
              measurements: Optional[List[dict]] = None, *,
              device=None) -> pathlib.Path:
    """Persist a measured plan with its measurement as metadata, stamped
    with the current ``PLAN_SCHEMA``.  ``measurements`` is the autotune
    lap's per-candidate table (plan fields + ``p50_ms`` each), kept so the
    cost model (`repro_torch.analysis.cost`) can check its predicted
    ordering against every measured candidate."""
    params = _coerce_params(params)
    dev = resolve_device(device)
    path = _cache_path(cache_path)
    data = _read_cache(path)
    entry = plan.to_json()
    entry.update({"schema": PLAN_SCHEMA, "p50_ms": float(p50_ms),
                  "measured_at": time.time(), "backend": dev.type})
    if measurements:
        entry["measurements"] = [
            {**m, "p50_ms": float(m["p50_ms"])} for m in measurements
        ]
    data["plans"][cache_key(params, lanes, dev)] = entry
    _write_cache(path, data)
    return path


def _entry_schema(entry: dict) -> int:
    """Schema an entry was measured under (1 = legacy, pre-stamp)."""
    try:
        return int(entry.get("schema", 1))
    except (TypeError, ValueError):
        return 0


def _entry_plan(entry: dict, params: CipherParams,
                device: torch.device) -> Optional[StreamPlan]:
    """Parse and validate one cache entry; None when it must not be
    trusted (stale schema, malformed, or naming unusable backends)."""
    if _entry_schema(entry) != PLAN_SCHEMA:
        return None
    try:
        plan = StreamPlan.from_json(entry)
    except (KeyError, TypeError, ValueError):
        return None
    return plan if _plan_is_valid(plan, params, device) else None


def _nearest(plans: dict, params: CipherParams, lanes: Optional[int],
             device: torch.device, parse) -> Optional[object]:
    """The parsed entry of the tuned lane count nearest ``lanes`` for the
    same (preset, noise, host); ``lanes=None`` targets the largest.  Ties
    break toward the smaller lane count."""
    prefix = f"{params.name}|lanes="
    suffix = f"|noise={params.n_noise}|host={host_fingerprint(device)}"
    candidates: List[Tuple[int, object]] = []
    for key, entry in plans.items():
        if not (key.startswith(prefix) and key.endswith(suffix)):
            continue
        try:
            lane_n = int(key[len(prefix): len(key) - len(suffix)])
        except ValueError:
            continue
        got = parse(entry)
        if got:
            candidates.append((lane_n, got))
    if not candidates:
        return None
    target = lanes if lanes is not None else max(n for n, _ in candidates)
    candidates.sort(key=lambda nv: (abs(nv[0] - target), nv[0]))
    return candidates[0][1]


def load_plan(params: Union[CipherParams, str], lanes: Optional[int] = None,
              cache_path=None, *, device=None) -> Optional[StreamPlan]:
    """Cache-only lookup (never measures): the tuned plan for (preset,
    lanes) on this host and device, or None.

    With ``lanes=None``, or when the exact lane count was never tuned,
    falls back to the nearest tuned lane count (the largest for None).
    Entries naming backends that are gone, unavailable or not for this
    device, and entries of another ``PLAN_SCHEMA``, are ignored.
    """
    params = _coerce_params(params)
    dev = resolve_device(device)
    plans = _read_cache(_cache_path(cache_path))["plans"]
    exact = plans.get(cache_key(params, lanes, dev))
    if exact is not None:
        return _entry_plan(exact, params, dev)
    return _nearest(plans, params, lanes, dev,
                    lambda e: _entry_plan(e, params, dev))


def load_measurements(params: Union[CipherParams, str],
                      lanes: Optional[int] = None,
                      cache_path=None, *, device=None) -> List[dict]:
    """The per-candidate timing table the last autotune lap persisted for
    (preset, lanes) on this host and device — ``[]`` when none.  Rows are
    raw measurements (not validated against today's backends), but
    stale-schema entries are ignored; ``lanes=None`` uses the nearest
    tuned lane count, as :func:`load_plan` does."""
    params = _coerce_params(params)
    dev = resolve_device(device)
    plans = _read_cache(_cache_path(cache_path))["plans"]

    def rows(entry) -> List[dict]:
        if entry is None or _entry_schema(entry) != PLAN_SCHEMA:
            return []
        return [r for r in entry.get("measurements", [])
                if isinstance(r, dict) and "p50_ms" in r]

    exact = rows(plans.get(cache_key(params, lanes, dev)))
    if exact:
        return exact
    return _nearest(plans, params, lanes, dev, rows) or []


# ==========================================================================
# Measurement: the real farm loop, per candidate plan
# ==========================================================================
def candidate_plans(params: Union[CipherParams, str], lanes: int, *,
                    device=None,
                    producers: Optional[Sequence[str]] = None,
                    engines: Optional[Sequence[str]] = None,
                    variants: Optional[Sequence[str]] = None,
                    windows: Optional[Sequence[int]] = None,
                    depths: Optional[Sequence[int]] = None,
                    matrix_depths: Optional[Sequence[int]] = None,
                    reductions: Optional[Sequence[str]] = None
                    ) -> List[StreamPlan]:
    """The default candidate grid for one (preset, lanes) shape.

    Producers: every stream-preserving backend.  Engines: every available
    engine that runs on the device except the oracle ``ref`` — or
    ``["ref"]`` when that leaves none (an explicit CPU).  Windows: the
    full batch and half of it; depths 2 and 3; matrix depths 1 and 2 on
    stream-matrix presets (PASTA), else 1; reductions lazy and eager.
    Explicit sequences override any dimension.
    """
    params = _coerce_params(params)
    if producers is None:
        producers = compatible_producers(params)
    if engines is None:
        dev = resolve_device(device)
        engines = [n for n, c in engine_caps().items()
                   if c.available and dev.type in c.device_types
                   and n not in ORACLES]
        if not engines:
            engines = ["ref"]
    if variants is None:
        variants = ("normal", "alternating")
    if windows is None:
        windows = sorted({lanes, lanes // 2} - {0})
    if depths is None:
        depths = (2, 3)
    if matrix_depths is None:
        matrix_depths = (1, 2) if params.n_matrix_constants else (1,)
    if reductions is None:
        reductions = ("lazy", "eager")
    return [StreamPlan(prod, eng, var, int(win), int(dep), int(mdep),
                       str(red))
            for prod in producers for eng in engines for var in variants
            for win in windows for dep in depths for mdep in matrix_depths
            for red in reductions]


def _window_latencies(params: CipherParams, plan: StreamPlan,
                      sessions: int, n_windows: int, reps: int, seed: int,
                      dev: torch.device) -> List[float]:
    """Seconds per timed window of one plan; the pool, farm and producer
    live only inside this call."""

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    batch = CipherBatch(params, seed=seed, producer=plan.producer,
                        device=dev)
    batch.add_sessions(sessions)
    farm = KeystreamFarm(batch, engine=plan.engine, variant=plan.variant,
                         depth=plan.depth, matrix_depth=plan.matrix_depth,
                         reduction=plan.reduction)
    total = plan.window * n_windows
    sids = np.resize(np.arange(sessions, dtype=np.int64), total)

    def wplans(base: int):
        # counters unique per (session, lane occurrence); tuning sends
        # nothing, so plain ranges do
        ctrs = base + np.arange(total, dtype=np.int64) // sessions
        return pack_windows(sids, ctrs, plan.window)

    for _ in farm.run(wplans(0)):               # warm-up lap
        sync()
    lat: List[float] = []
    for rep in range(reps):
        it = farm.run(wplans((rep + 1) * total))
        while True:
            t0 = time.perf_counter()
            try:
                next(it)
            except StopIteration:
                break
            sync()
            lat.append(time.perf_counter() - t0)
    return lat


def measure_plan(params: Union[CipherParams, str], plan: StreamPlan,
                 lanes: int, *, sessions: int = 2, n_windows: int = 4,
                 reps: int = 2, seed: int = 0, device=None) -> float:
    """Per-window p50 latency (seconds) of one plan on the real farm loop.

    Runs ``n_windows`` windows of ``plan.window`` lanes over a
    ``sessions``-session pool, ``reps`` times, after a warm-up lap that
    absorbs the first use (the kernels' build on a card).  Each window is
    timed on the host clock around ``next(it)`` up to its keystream being
    ready on the device (`torch.cuda.synchronize`).  The pool, farm and
    producer (a ``cached`` producer's planes too) are released and the
    allocator's cache emptied before returning, so candidates never pile
    up device memory.
    """
    params = _coerce_params(params)
    dev = resolve_device(device)
    lat = _window_latencies(params, plan, sessions, n_windows, reps, seed,
                            dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return float(np.percentile(np.asarray(lat), 50))


def autotune(params: Union[CipherParams, str], lanes: int, *,
             sessions: int = 2, n_windows: int = 4, reps: int = 2,
             producers: Optional[Sequence[str]] = None,
             engines: Optional[Sequence[str]] = None,
             variants: Optional[Sequence[str]] = None,
             windows: Optional[Sequence[int]] = None,
             depths: Optional[Sequence[int]] = None,
             reductions: Optional[Sequence[str]] = None,
             cache_path=None, force: bool = False,
             verbose: bool = False, device=None) -> StreamPlan:
    """Measure every candidate plan and return (and persist) the winner.

    A valid persisted plan for (preset, lanes, host, device) is returned
    as it is, without timing, unless ``force=True``.  Selection is by
    measured per-window p50; ties break toward the earlier candidate.
    """
    params = _coerce_params(params)
    dev = resolve_device(device)
    if not force:
        cached = load_plan(params, lanes, cache_path, device=dev)
        if cached is not None:
            if verbose:
                print(f"[tuner] cache hit for {params.name}/lanes={lanes}: "
                      f"{cached.describe()}")
            return cached
    plans = candidate_plans(params, lanes, device=dev, producers=producers,
                            engines=engines, variants=variants,
                            windows=windows, depths=depths,
                            reductions=reductions)
    if not plans:
        raise RuntimeError("no candidate StreamPlans (empty grid?)")
    best: Optional[StreamPlan] = None
    best_p50 = float("inf")
    measurements: List[dict] = []
    for plan in plans:
        p50 = measure_plan(params, plan, lanes, sessions=sessions,
                           n_windows=n_windows, reps=reps, device=dev)
        measurements.append({**plan.to_json(), "p50_ms": p50 * 1e3})
        if verbose:
            print(f"[tuner] {plan.describe():60s} p50={p50 * 1e3:8.3f} ms")
        if p50 < best_p50:
            best, best_p50 = plan, p50
    path = save_plan(params, lanes, best, best_p50 * 1e3, cache_path,
                     measurements=measurements, device=dev)
    if verbose:
        print(f"[tuner] winner: {best.describe()} "
              f"(p50={best_p50 * 1e3:.3f} ms) -> {path}")
    return best


# ==========================================================================
# Introspection CLI: `python -m repro_torch.core.tuner`
# ==========================================================================
def describe(cache_path=None, device=None) -> str:
    """The cached StreamPlans of this host and device, beside the
    producer and engine registry tables."""
    from repro_torch.core import engine as engine_mod
    from repro_torch.core import producer as producer_mod

    dev = resolve_device(device)
    path = _cache_path(cache_path)
    plans = _read_cache(path)["plans"]
    fp = host_fingerprint(dev)
    lines = [f"=== cached StreamPlans (this host, {dev.type}) ==="]
    rows = [("key", "producer", "engine", "variant", "window", "depth",
             "mdepth", "reduction", "p50 ms")]
    for key in sorted(plans):
        if f"|host={fp}" not in key:
            continue
        e = plans[key]
        schema = _entry_schema(e)
        stale = "" if schema == PLAN_SCHEMA else \
            f"  [STALE schema {schema} != {PLAN_SCHEMA}: ignored]"
        rows.append((key.split("|host=")[0], str(e.get("producer")),
                     str(e.get("engine")), str(e.get("variant")),
                     str(e.get("window")), str(e.get("depth")),
                     str(e.get("matrix_depth", 1)),
                     str(e.get("reduction", "lazy")),
                     f"{e.get('p50_ms', float('nan')):.3f}" + stale))
    if len(rows) == 1:
        lines.append(f"  (none at {path}; run --autotune)")
    else:
        widths = [max(len(r[i]) for r in rows) for i in range(9)]
        for i, r in enumerate(rows):
            lines.append("  ".join(r[j].ljust(widths[j]) for j in range(9)))
            if i == 0:
                lines.append("  ".join("-" * w for w in widths))
    lines += ["", "=== producer registry ===", producer_mod.describe(),
              "", "=== engine registry ===", engine_mod.describe(dev)]
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--autotune", action="store_true",
                    help="measure (and persist) a plan before printing")
    ap.add_argument("--preset", default="rubato-128l")
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--sessions", type=int, default=2)
    ap.add_argument("--windows", type=int, default=4,
                    help="timed windows per rep")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--force", action="store_true",
                    help="re-measure even on a cache hit")
    ap.add_argument("--cache", default=None,
                    help=f"cache path (default ${_ENV_CACHE} or "
                         f"{default_cache_path()})")
    ap.add_argument("--device", default=None,
                    help="device to tune for (default: the card)")
    args = ap.parse_args(argv)
    if args.autotune:
        plan = autotune(args.preset, args.lanes, sessions=args.sessions,
                        n_windows=args.windows, reps=args.reps,
                        cache_path=args.cache, force=args.force,
                        verbose=True, device=args.device)
        print(f"\ntuned plan for {args.preset}/lanes={args.lanes}: "
              f"{plan.describe()}\n")
    print(describe(args.cache, args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
