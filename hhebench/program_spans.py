"""What the train cell's readers take from the program's own records
(`repro_torch.obs`) in a traced stretch: the device time inside a span,
a step, and a counter's values.  Each gives None where the program
recorded nothing there, or has no such records (an older program)."""

from __future__ import annotations

from collections import defaultdict
from typing import List, Optional

from hhebench.trace import merge, overlap


def _records(run, name: str):
    t = run.trace
    if t is None or not t.units:
        return None
    try:
        from repro_torch import obs
    except ImportError:     # a program without spans
        return None
    lo, hi = t.window
    return [r for r in obs.records()
            if r.name == name and lo <= r.start_ns and r.end_ns <= hi]


def main_stream(trace) -> Optional[int]:
    """The stream that ran the most device time in the stretch: the train
    step's (the farm's producer runs on a stream of its own)."""
    busy = defaultdict(int)
    for o in trace.ops:
        busy[o.stream] += o.end - o.start
    return max(busy, key=busy.get) if busy else None


def ms_per_unit(run, name: str) -> Optional[float]:
    """Device time a step inside the spans ``name``: the time the main
    stream's operations ran while such a span was open on the host, on
    the profiler's clock, summed over the traced stretch.  The stream's
    idle time inside a span does not count; an operation that a span
    launched and that ran after it closed counts to what ran then."""
    recs = _records(run, name)
    t = run.trace
    if not recs or not t.ops:
        return None
    main = main_stream(t)
    ops = merge(t.intervals(lambda o: o.stream == main))
    spans = merge([(r.start_ns, r.end_ns) for r in recs])
    return overlap(spans, ops) * 1e-6 / t.units


def counts(run, name: str) -> Optional[List[List[int]]]:
    """The values of the counters ``name`` in the traced stretch, one
    list a record."""
    recs = _records(run, name)
    return [r.value for r in recs] if recs else None
