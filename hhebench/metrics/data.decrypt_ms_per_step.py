"""Device time a step of the decryption of the step's cipher text on the
card, its keystream and the subtraction (data.decrypt spans):
the main stream's operations that ran while such a span was open on
the host (`hhebench.program_spans.ms_per_unit`), summed over the
traced stretch and divided by its steps; the stream's idle time
inside a span does not count. None where the program records no
such spans."""

from hhebench.program_spans import ms_per_unit


def read(run):
    return ms_per_unit(run, "data.decrypt")
