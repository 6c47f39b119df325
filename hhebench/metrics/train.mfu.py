"""Model FLOPs utilisation of the window's train steps: a step's model
FLOPs (`hhebench.train_cost.step_flops`: the widths, and the assignments
the held experts computed a step, from the traced stretch's
``moe.computed`` counters) over the window's time a step (the host's
clock, untraced), over the card's bfloat16 peak.  None without a device
timeline (a CPU run) or where the program records no such counters."""

from hhebench import train_cost
from hhebench.program_spans import counts


def read(run):
    done = counts(run, "moe.computed")
    if not done or not run.trace.ops:
        return None
    tr = run.cell.traffic
    flops = train_cost.step_flops(
        run.cell.cfg, tr["batch"] * tr["seq_len"], tr["seq_len"],
        sum(map(sum, done)) / run.trace.units)
    return 100.0 * flops / (run.host["step_ms"] * 1e-3) \
        / train_cost.peak_flops(run.kind)
