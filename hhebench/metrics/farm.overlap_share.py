"""How far the farm's FIFO hides one stage behind the other: device time
in which the producer's stream (where the AES XOF kernel runs) and the
consumer's (where the keystream kernel runs) are both busy, as a share of
the busy time of the less busy of the two."""

from hhebench.trace import merge, overlap


def read(run):
    t = run.trace
    if t is None:
        return None
    prod, cons = t.stream_of("aes_xof_kernel"), t.stream_of("keystream_kernel")
    if prod is None or cons is None or prod == cons:
        return None
    p = merge(t.intervals(lambda o: o.stream == prod))
    c = merge(t.intervals(lambda o: o.stream == cons))
    least = min(sum(b - a for a, b in p), sum(b - a for a, b in c))
    return 100.0 * overlap(p, c) / least if least else None
