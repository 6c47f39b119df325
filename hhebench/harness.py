"""The cell-independent part of a run: find the cell's files by name,
make its inputs from the seed, pick and read its metrics, judge the
checks, and print the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Its
configuration is ``hhebench/configs/<config>.json``, its traffic
``hhebench/traffic/<traffic>.json``, whose ``loop`` names the loop module
that drives it (``hhebench/<loop>.py``), and each per-layer metric is a
reader ``hhebench/metrics/<name>.py`` with a ``read(run)`` function.
Adding any of them adds a file and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: Top-level module names the process that prints a result must not hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: Block counters a nonce can serve: each owns 2^16 of the 32-bit AES
#: counter (`hhebench.reference.aes.CTR_SPACE`).
CTR_LIMIT = 1 << 16


@dataclasses.dataclass
class Cell:
    """One run of one cell, as the loops see it."""

    name: str
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any                   # torch.device
    control: Optional[str] = None  # "bf16": the reference in the program's place
    t_process: float = 0.0        # perf_counter() at process start


@dataclasses.dataclass
class Outcome:
    """What a loop hands back: its host-clock numbers, its checks (name ->
    (value, limit)), the trace of its traced stretch, if any."""

    setup_s: float
    host: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, Tuple[float, float]]
    memory_peak_bytes: int
    trace: Any = None


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader reads."""

    cell: Cell
    outcome: Outcome
    kind: str                     # the card's name

    @property
    def trace(self):
        return self.outcome.trace

    @property
    def host(self) -> Dict[str, float]:
        return self.outcome.host


# --- finding a cell's files ------------------------------------------------
def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}; have "
                   f"{[e['name'] for e in entries]}")


def resolve(bench: dict, workload: str) -> Tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic) of a cell."""
    w = _named(bench["workloads"], workload, "workload")
    c = _named(bench["configs"], w["config"], "configuration")
    cfg = json.loads((ROOT / c["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    return w, cfg, traffic


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def loop_module(traffic: dict):
    return importlib.import_module(f"hhebench.{traffic['loop']}")


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"hhebench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# --- inputs from the seed --------------------------------------------------
class NonceBook:
    """Every nonce a run hands the program, drawn in order from the
    seed's generator; the reference reads them back by index."""

    def __init__(self, rng: np.random.Generator):
        self._rng = rng
        self.nonces: List[np.ndarray] = []

    def new(self) -> int:
        self.nonces.append(self._rng.integers(0, 256, 16, dtype=np.uint8))
        return len(self.nonces) - 1

    def __getitem__(self, i: int) -> np.ndarray:
        return self.nonces[i]

    def array(self) -> np.ndarray:
        return np.stack(self.nonces)


def torch_generator(rng: np.random.Generator, device):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(int(rng.integers(0, 2 ** 62)))
    return g


def check_params(params, cfg: dict) -> None:
    """The program's preset must be the configuration as its file states
    it; a mismatch stops the run before any work."""
    got = {"kind": params.kind, "n": params.n, "l": params.l,
           "rounds": params.rounds, "q": params.mod.q,
           "sigma": params.sigma, "xof": params.xof}
    want = {k: cfg[k] for k in got}
    if got != want:
        raise ValueError(f"program preset {params.name} is {got}, the "
                         f"configuration file states {want}")


def percentile(values, p: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), p))


# --- the result ------------------------------------------------------------
def metrics_line(bench: dict, cell: Cell, outcome: Outcome, kind: str
                 ) -> Dict[str, dict]:
    """The cell's end-to-end metrics (untraced run) or per-layer ones
    (traced run), by name, each {"value", "unit"}; a reader that finds
    nothing leaves its metric out."""
    out = {}
    if not cell.trace:
        for m in bench["end_to_end"]:
            if applies(m, cell.name):
                v = (outcome.setup_s if m["name"] == "setup_s"
                     else outcome.host[m["name"]])
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
        return out
    run = Run(cell, outcome, kind)
    for m in bench["per_layer"]:
        if applies(m, cell.name):
            v = reader(m["name"])(run)
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def device_block(cell: Cell, outcome: Outcome) -> dict:
    import torch

    dev = cell.device
    if dev.type == "cuda":
        block = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                 "count": 1}
    else:
        block = {"platform": "cpu", "kind": "cpu", "count": 1}
    block["memory_peak_bytes"] = int(outcome.memory_peak_bytes)
    if outcome.trace is not None:
        block["busy_s"] = outcome.trace.busy_s()
        block["window_s"] = outcome.trace.window_s
    return block


def result(bench: dict, cell: Cell, outcome: Outcome) -> dict:
    dev = device_block(cell, outcome)
    correct = all(v <= lim for v, lim in outcome.checks.values())
    line = {"correct": correct, "attempted": int(outcome.attempted),
            "failed": int(outcome.failed),
            "metrics": metrics_line(bench, cell, outcome, dev["kind"]),
            "device": dev}
    if outcome.trace is not None:
        line["breakdown"] = {"device_ops": outcome.trace.top_ops(),
                             "idle_gaps": outcome.trace.idle_gaps()}
    line["host"] = outcome.host
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in outcome.checks.items()}
    return line


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, control: Optional[str] = None, t_process: float = 0.0,
             traffic_overrides: Optional[dict] = None,
             bench: Optional[dict] = None) -> dict:
    """One run of one cell: the result line as a dict.  The tests call
    this on the CPU with ``traffic_overrides`` that shrink the traffic."""
    import torch

    bench = load_benchmark() if bench is None else bench
    _, cfg, traffic = resolve(bench, workload)
    traffic = {**traffic, **(traffic_overrides or {})}
    cell = Cell(workload, cfg, traffic, seed, seconds, trace,
                torch.device(device), control, t_process)
    outcome = loop_module(traffic).run(cell)
    return result(bench, cell, outcome)
