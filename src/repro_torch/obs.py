"""Spans over the port's keystream path, on the profiler's clock.

A span is off unless a torch profiler is recording: then ``span`` makes
one check and hands back a shared no-op context, reading no clock and
calling nothing in torch.  Under a profiler a span opens a profiler
range of its name, so an exported timeline shows it beside the kernels,
and keeps a :class:`Record` in memory: its name,
its start and end in ``time.time_ns()`` (the profiler's own clock) and
the span it opened inside (one stack per thread).  A span given ``stream=`` on a CUDA device also records a pair of
timing events on that stream; their elapsed time is read when a record's
``device_ms`` is first asked for, after the traced stretch has
synchronised.

    with torch.profiler.profile(activities=[...]) as prof:
        for plan, ct in farm.encrypt_stream(jobs, delta):
            ...
    prof.export_chrome_trace("farm.json")   # the spans beside the kernels
    obs.records()                           # the spans in memory

Tracing has no setting of its own: whoever runs the profiler sees the
spans.  A count is the number of records of one name; a counter
(`count`) is a record that carries a value, made where a layer knows
how much work it did.

The range is a function-scope one (``_RecordFunctionFast``), which the
profiler keeps on the host's timeline alone: a user-scope
``record_function`` would also lay a range of the span's name over the
device's timeline, where a reader of device operations would count it
as device work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import List, Optional

import torch
import torch.autograd.profiler as _profiler
from torch._C import _profiler as _ranges

_OFF = contextlib.nullcontext()
_records: List["Record"] = []
_local = threading.local()


@dataclasses.dataclass(eq=False)
class Record:
    """One span: host times in ns on the profiler's clock; ``parent`` is
    the record of the span it opened inside, on the same thread."""

    name: str
    start_ns: int
    end_ns: Optional[int] = None
    parent: Optional["Record"] = dataclasses.field(default=None, repr=False)
    events: Optional[tuple] = dataclasses.field(default=None, repr=False)
    _device_ms: Optional[float] = dataclasses.field(default=None, repr=False)
    value: Optional[List[int]] = None     # a counter's; None for a span

    @property
    def device_ms(self) -> Optional[float]:
        """Device time between the span's two stream events (waits for
        the second), or None for a span without them."""
        if self.events is not None:
            start, end = self.events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self.events = None
        return self._device_ms

    def under(self, name: str) -> bool:
        """Whether this span is ``name`` or opened inside one."""
        r = self
        while r is not None and r.name != name:
            r = r.parent
        return r is not None


def _stream(where) -> Optional[torch.cuda.Stream]:
    """The current stream of ``where``'s device (a device or a tensor),
    or None off the card."""
    dev = where if isinstance(where, torch.device) else where.device
    return torch.cuda.current_stream(dev) if dev.type == "cuda" else None


@contextlib.contextmanager
def _recorded(name: str, where):
    stack = _local.__dict__.setdefault("stack", [])
    parent = stack[-1] if stack else None
    with _ranges._RecordFunctionFast(name):
        rec = Record(name, time.time_ns(), parent=parent)
        stream = None if where is None else _stream(where)
        if stream is not None:
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record(stream)
        stack.append(rec)
        _records.append(rec)
        try:
            yield rec
        finally:
            stack.pop()
            if stream is not None:
                rec.events[1].record(stream)
            rec.end_ns = time.time_ns()


def span(name: str, stream=None):
    """A context over one stage; ``stream`` (a device or a tensor on one)
    times the stage on that device's current stream too."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _recorded(name, stream)


def counting() -> bool:
    """Whether `count` records now: under a profiler, and not while
    autograd runs a backward pass.  A layer asks before it computes a
    value that only a counter reads."""
    return (_profiler._is_profiler_enabled
            and torch._C._current_graph_task_id() == -1)


def count(name: str, value) -> None:
    """A counter: under a profiler, one closed record of ``name`` whose
    ``value`` is ``value`` (a list of ints), its parent the span open on
    this thread.  Not made while autograd runs a backward pass: a
    checkpointed layer recomputed there counts its work once, in the
    forward pass."""
    if not counting():
        return
    stack = _local.__dict__.setdefault("stack", [])
    now = time.time_ns()
    _records.append(Record(name, now, now, parent=stack[-1] if stack
                           else None, value=list(value)))


def records() -> List[Record]:
    """Every span closed since the last `clear`, in the order opened.

    The store is unbounded and outlives the profiler: every profiled
    stretch adds its records (and a device span's two events) until
    `clear` drops them, so call `clear` before each stretch."""
    return [r for r in _records if r.end_ns is not None]


def clear() -> None:
    _records.clear()
