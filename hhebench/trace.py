"""A traced stretch of a run: `torch.profiler` over a fixed amount of the
cell's own work, reduced to device operations by stream and name and to
the harness's own host spans.

The device operations are the profiler's kernel, memcpy and memset
records; the host spans are the ``hhebench.*`` ranges the loops open
around their calls into the program (`Spans`).  Everything here past
`capture` works on plain tuples, so the CPU tests feed it made-up events.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from typing import Callable, List, Optional, Tuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "hhebench.window"

Interval = Tuple[int, int]


class Spans:
    """Named host ranges around the loops' calls into the program.  Off,
    they cost nothing: the measured window runs with them off."""

    def __init__(self, on: bool = False):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int     # ns
    end: int       # ns
    stream: int


@dataclasses.dataclass
class Trace:
    ops: List[DeviceOp]
    spans: List[Tuple[str, int, int]]   # (name, start ns, end ns)
    window: Interval                    # the traced stretch, ns
    units: int                          # jobs or windows in the stretch
    lanes: int                          # lanes those units carried
    inside: str = "the loop"            # what runs between the loop's spans

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def intervals(self, pred: Callable[[DeviceOp], bool] = lambda o: True
                  ) -> List[Interval]:
        lo, hi = self.window
        return [(max(o.start, lo), min(o.end, hi)) for o in self.ops
                if pred(o) and o.end > lo and o.start < hi]

    def busy_s(self, pred: Callable[[DeviceOp], bool] = lambda o: True
               ) -> float:
        return covered(merge(self.intervals(pred))) * 1e-9

    def kernel_s(self, name_part: str) -> Tuple[float, int]:
        """Summed device time and count of the operations whose name holds
        ``name_part``."""
        ops = [o for o in self.ops if name_part in o.name]
        return sum(o.end - o.start for o in ops) * 1e-9, len(ops)

    def stream_of(self, name_part: str) -> Optional[int]:
        """The stream the operations named ``name_part`` ran on (the most
        of them), or None."""
        count = defaultdict(int)
        for o in self.ops:
            if name_part in o.name:
                count[o.stream] += 1
        return max(count, key=count.get) if count else None

    def top_ops(self, k: int = 10) -> List[list]:
        total = defaultdict(int)
        for o in self.ops:
            total[o.name] += o.end - o.start
        top = sorted(total.items(), key=lambda kv: -kv[1])[:k]
        return [[short_name(n), t * 1e-9] for n, t in top]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Device idle time inside the stretch, by the innermost host span
        open at each gap's midpoint; `WINDOW_SPAN` alone is named
        ``inside``, what the loop runs between its own spans."""
        lo, hi = self.window
        busy = merge(self.intervals())
        gaps, t = [], lo
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < hi:
            gaps.append((t, hi))
        # sweep the gaps' midpoints and the spans' edges in time order
        edges = sorted([(s[1], 1, i) for i, s in enumerate(self.spans)]
                       + [(s[2], 0, i) for i, s in enumerate(self.spans)])
        active, e, total = set(), 0, defaultdict(int)
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (a + b) // 2
            while e < len(edges) and edges[e][0] <= mid:
                t, opens, i = edges[e]
                (active.add if opens else active.discard)(i)
                e += 1
            inner = [self.spans[i] for i in active]
            name = (min(inner, key=lambda s: s[2] - s[1])[0] if inner
                    else "outside the loop")
            total[self.inside if name == WINDOW_SPAN else name] += b - a
        top = sorted(total.items(), key=lambda kv: -kv[1])[:k]
        return [[n, t * 1e-9] for n, t in top]


def short_name(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[: width - 3] + "..."


def merge(intervals: List[Interval]) -> List[Interval]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(merged: List[Interval]) -> int:
    return sum(b - a for a, b in merged)


def overlap(a: List[Interval], b: List[Interval]) -> int:
    """Length covered by both of two merged interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def capture(fn: Callable[[Spans], Tuple[int, int]], device,
            inside: str) -> Trace:
    """Run ``fn(spans)`` under the profiler, on the card.  ``fn`` returns
    (units, lanes) of the work it did and ends with the device idle; the
    stretch is the ``WINDOW_SPAN`` it runs in, and ``inside`` names what
    runs there outside the loop's own spans."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def _on_device(e) -> bool:
        # torch 2.13 names the activity; 2.11 has no activity_type(), and
        # there every device record but the annotations is an operation
        if hasattr(e, "activity_type"):
            return e.activity_type() in DEVICE_KINDS
        return e.device_type() == DeviceType.CUDA

    spans = Spans(on=True)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            units, lanes = fn(spans)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    ops, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        if name.startswith("hhebench."):
            if e.device_type() == DeviceType.CPU:
                host.append((name, start, end))
                if name == WINDOW_SPAN:
                    window = (start, end)
        elif _on_device(e):
            ops.append(DeviceOp(name, start, end, e.device_resource_id()))
    if window is None:
        raise RuntimeError("the profiler recorded no traced window")
    return Trace(ops, host, window, units, lanes, inside)
