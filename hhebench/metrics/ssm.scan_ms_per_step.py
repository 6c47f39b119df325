"""Device time a step of the Mamba-2 layers' chunked scans (ssm.scan spans
around ssd_chunked), forward and the recompute of checkpointed layers;
their backward is not inside:
the main stream's operations that ran while such a span was open on
the host (`hhebench.program_spans.ms_per_unit`), summed over the
traced stretch and divided by its steps; the stream's idle time
inside a span does not count. None where the program records no
such spans."""

from hhebench.program_spans import ms_per_unit


def read(run):
    return ms_per_unit(run, "ssm.scan")
