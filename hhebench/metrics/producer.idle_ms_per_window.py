"""Device idle time a window while the program produces a window's
constants.  Each gap in the traced stretch's device timeline goes to the
innermost program span open at its midpoint; the gaps whose span is
``farm.produce`` or one opened inside it (``cipher.tables``,
``producer.upload``, ``producer.xof``, ...) are summed and divided by the
stretch's windows.  None where the program records no spans."""

from hhebench.trace import merge


def read(run):
    t = run.trace
    if t is None or not t.ops or not t.units:
        return None
    try:
        from repro_torch import obs
    except ImportError:     # a program without spans
        return None
    lo, hi = t.window
    spans = [r for r in obs.records() if lo <= r.start_ns and r.end_ns <= hi]
    if not spans:
        return None
    idle, at = 0, lo
    for a, b in merge(t.intervals()) + [(hi, hi)]:
        if a > at:
            mid = (at + a) // 2
            inner = [r for r in spans if r.start_ns <= mid < r.end_ns]
            if inner and min(inner, key=lambda r: r.end_ns - r.start_ns
                             ).under("farm.produce"):
                idle += a - at
        at = max(at, b)
    return idle * 1e-6 / t.units
