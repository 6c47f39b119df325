"""The keystream kernel's share of its roofline: the least time of the
bytes it must move (`hhebench.cost.keystream_bytes_per_lane`, 4 bytes a
word) over its device time in the traced stretch."""

from hhebench import cost


def read(run):
    t = run.trace
    if t is None:
        return None
    seconds, n = t.kernel_s("keystream_kernel")
    if not n or seconds <= 0:
        return None
    need = cost.least_seconds(cost.keystream_bytes_per_lane(run.cell.cfg)
                              * t.lanes, run.kind)
    return 100.0 * need / seconds
