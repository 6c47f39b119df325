"""How often the cipher pool stacks its sessions' producer tables anew
(``cipher.tables`` spans: after a session joins or rotates to a fresh
nonce), a window of the traced stretch.  None where the program records
no spans."""


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    try:
        from repro_torch import obs
    except ImportError:     # a program without spans
        return None
    lo, hi = t.window
    names = [r.name for r in obs.records()
             if lo <= r.start_ns and r.end_ns <= hi]
    return names.count("cipher.tables") / t.units if names else None
