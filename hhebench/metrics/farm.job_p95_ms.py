"""The 95th percentile of every job's latency in the measured window,
from its push into the farm to its CUDA event completing (host clock).
Per-layer, since it flips between the jobs the device paces and those
the producer's host path stalls."""


def read(run):
    return run.host.get("job_p95_ms")
