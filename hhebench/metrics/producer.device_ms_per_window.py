"""Device time a window on the producer's stream (the farm's side
stream, the one the AES XOF kernel runs on): every kernel, copy and set
there, overlaps counted once, over the windows of the traced stretch."""


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    stream = t.stream_of("aes_xof_kernel")
    if stream is None:
        return None
    return t.busy_s(lambda o: o.stream == stream) * 1e3 / t.units
