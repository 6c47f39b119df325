"""The share of the traced stretch in which no kernel, copy or set ran on
the device."""


def read(run):
    t = run.trace
    if t is None or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
