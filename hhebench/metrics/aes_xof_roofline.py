"""The AES XOF kernel's share of its roofline: the least time of the
bytes any AES-128-CTR XOF must move (`hhebench.cost.xof_bytes_per_lane`:
each lane's counter and session in, its XOF words out, 4 bytes a word)
over the kernel's device time in the traced stretch."""

from hhebench import cost


def read(run):
    t = run.trace
    if t is None:
        return None
    seconds, n = t.kernel_s("aes_xof_kernel")
    if not n or seconds <= 0:
        return None
    need = cost.least_seconds(cost.xof_bytes_per_lane(run.cell.cfg)
                              * t.lanes, run.kind)
    return 100.0 * need / seconds
