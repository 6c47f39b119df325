"""The held experts' load imbalance: in each MoE call of the traced
stretch's forward passes (``moe.computed`` counters: the rows each held
expert's product ran on), the busiest expert's rows over the mean, then
the mean over the calls.  1 is an even load.  None where the program
records no such counters."""

from hhebench.program_spans import counts


def read(run):
    calls = [c for c in counts(run, "moe.computed") or () if sum(c)]
    if not calls:
        return None
    return sum(max(c) * len(c) / sum(c) for c in calls) / len(calls)
