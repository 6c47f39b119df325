"""Device time a window in the producer's XOF stage: the AES XOF
kernel (or the threefry words) and the words' widening to int64.  Each
``producer.xof`` span times its stage with a pair of events on the
producer's stream; their times are summed over the traced stretch and
divided by its windows.  None where the program records no such spans.

This is event-to-event time on the stream, not the sum of the stage's
kernels: where the stream idles between the two events, because the
host is stalled in an upload or still launching the stage, that idle
counts too."""


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    try:
        from repro_torch import obs
    except ImportError:     # a program without spans
        return None
    lo, hi = t.window
    ms = [r.device_ms for r in obs.records() if r.name == "producer.xof"
          and lo <= r.start_ns and r.end_ns <= hi]
    ms = [m for m in ms if m is not None]
    return sum(ms) / t.units if ms else None
