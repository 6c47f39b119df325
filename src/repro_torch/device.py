"""Device policy for the port's entry points.

``device=None`` means the card.  There is no quiet fallback: without a
CUDA device an entry point raises and names ``device="cpu"``, the one way
to ask for the plain PyTorch path on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """None -> ``cuda``; raises when a CUDA device is asked for (or
    implied) but none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default — pass device=\"cpu\" to run the plain PyTorch path "
            "on the host")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def upload(array, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``, queued on the current stream
    without making the host wait for that stream.  A copy from pageable
    memory first waits for all work already queued on the stream (inside
    a farm produce: the previous window's producer on the side stream),
    so the copy goes through pinned memory, asynchronously."""
    t = torch.from_numpy(np.require(array, requirements=["C", "W"]))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
