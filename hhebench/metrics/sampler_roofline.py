"""The producer's two sampler kernels' share of their roofline: the least
time of the bytes any sampler of a block's XOF row must move (its XOF
words in, its round constants and noise out, 4 bytes a word) over the
summed device time of `sampler_uniform_kernel` and `sampler_gauss_kernel`
in the traced stretch.  None where neither kernel ran (a program that
samples in plain PyTorch)."""

from hhebench import cost
from hhebench.reference.cipher import xof_layout

KERNELS = ("sampler_uniform_kernel", "sampler_gauss_kernel")


def read(run):
    t = run.trace
    if t is None:
        return None
    seconds = launches = 0
    for name in KERNELS:
        s, n = t.kernel_s(name)
        seconds, launches = seconds + s, launches + n
    if not launches or seconds <= 0:
        return None
    lay = xof_layout(run.cell.cfg)
    per_lane = cost.WORD_BYTES * (lay["words"] + lay["n_rc"] + lay["n_noise"])
    return 100.0 * cost.least_seconds(per_lane * t.lanes, run.kind) / seconds
