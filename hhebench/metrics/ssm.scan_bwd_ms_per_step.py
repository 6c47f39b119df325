"""Device time a step of the Mamba-2 layers' chunked-scan backward
(ssm.scan_bwd spans around the scan kernels' backward launches, opened on
autograd's thread): each span's two CUDA events, recorded on the main
stream as it opens and as it closes, timed against each other
(`repro_torch.obs.Record.device_ms`), summed over the traced stretch and
divided by its steps.  The kernels run after the host has launched them
and left the span, so the host span's overlap with the stream (what
`hhebench.program_spans.ms_per_unit` reads) would miss them; the events
sit in the stream's order around them instead.  None where the program
records no such spans, or none with events."""

from hhebench.program_spans import _records


def read(run):
    recs = _records(run, "ssm.scan_bwd")
    ms = [m for m in (r.device_ms for r in recs or ()) if m is not None]
    return sum(ms) / run.trace.units if ms else None
