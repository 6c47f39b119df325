"""The least work of the keystream path's kernels, and the card's peaks.

Copied, not imported: the program's own copy (`repro_torch.analysis.cost`
`analyze_cost`, `repro_torch.launch.roofline`) may change in a later PR,
and the yardstick must not.  Every count follows from the cipher's
parameters (a configuration file), at 4 bytes a Z_q or XOF word, never
from how a kernel lays its planes out or computes.
"""

from __future__ import annotations

from hhebench.reference.cipher import xof_layout

#: Memory bandwidth by `torch.cuda.get_device_name`: the NVIDIA H100 SXM
#: data sheet (700 W).
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
WORD_BYTES = 4


def keystream_bytes_per_lane(cfg: dict) -> int:
    """The keystream kernel: a block's round constants and noise in, its
    l keystream words out (`analyze_cost`'s count)."""
    lay = xof_layout(cfg)
    return WORD_BYTES * (lay["n_rc"] + lay["n_noise"] + cfg["l"])


def xof_bytes_per_lane(cfg: dict) -> int:
    """The XOF kernel: a block's counter and session index in, the XOF
    words its constants and noise draw out."""
    return WORD_BYTES * (2 + xof_layout(cfg)["words"])


def least_seconds(bytes_moved: float, kind: str) -> float:
    """The least time the card ``kind`` can move ``bytes_moved`` in."""
    if kind not in HBM_BYTES_PER_S:
        raise KeyError(f"no peak on record for {kind!r}; have "
                       f"{sorted(HBM_BYTES_PER_S)}")
    return bytes_moved / HBM_BYTES_PER_S[kind]
