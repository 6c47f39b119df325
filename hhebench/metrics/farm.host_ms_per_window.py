"""Host time a window in the farm's own calls: the summed length of the
program's outermost spans, ``farm.produce`` (the producer's dispatch),
``farm.consume`` (the engine's) and ``farm.encrypt`` (the encrypt
boundary), over the traced stretch's windows.  None where the program
records no spans."""

TOP = ("farm.produce", "farm.consume", "farm.encrypt")


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    try:
        from repro_torch import obs
    except ImportError:     # a program without spans
        return None
    lo, hi = t.window
    ns = [r.end_ns - r.start_ns for r in obs.records()
          if r.parent is None and r.name in TOP
          and lo <= r.start_ns and r.end_ns <= hi]
    return sum(ns) * 1e-6 / t.units if ns else None
