"""Carry a reference model's parameters across to the port.

:func:`params_from_reference` builds a port :class:`Model` from the
reference's parameter tree (``{"embed", ..., "blocks": [slot dicts]}``)
as numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``: the same
names and layouts, so it is a name-for-name copy with no transposes.
:func:`params_to_numpy` is its inverse.  Only numpy arrays cross, so
nothing here imports the reference.

bfloat16 leaves cross as their bits: the reference's (an ``ml_dtypes``
bfloat16 array, 2 bytes an element) and any 2-byte array are read as raw
bf16 bit patterns, and :func:`params_to_numpy` gives them back as
``uint16`` bit patterns, so a round trip is bit-exact without a bfloat16
numpy type.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import Model, iter_defs, param_dtype


def _leaf(tree, path):
    node = tree
    for key in path:
        node = node[key]
    return np.asarray(node)


def _to_tensor(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if dtype == torch.bfloat16:
        if a.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf needs 2-byte elements, got "
                             f"{a.dtype}")
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype != np.float32:
        raise ValueError(f"a float32 leaf got {a.dtype}")
    return torch.from_numpy(a.copy())


def params_from_reference(cfg: ModelConfig, tree, device=None) -> Model:
    """Reference parameter tree (numpy leaves) -> :class:`Model` on
    ``device`` (default: the card).  Every leaf's dtype is checked here
    and its shape by :class:`Model`, against
    :func:`repro_torch.models.model.param_defs`."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {"blocks": [{} for _ in cfg.group]}
    for path, d in iter_defs(cfg):
        t = _to_tensor(_leaf(tree, path), param_dtype(cfg, d)).to(dev)
        if path[0] == "blocks":
            out["blocks"][path[1]][path[2]] = t
        else:
            out[path[0]] = t
    return Model(cfg, out)


def params_to_numpy(model: Model) -> Dict[str, Any]:
    """:class:`Model` -> the reference's tree of numpy arrays (float32, or
    ``uint16`` bit patterns for bfloat16)."""
    out: Dict[str, Any] = {"blocks": [{} for _ in model.cfg.group]}
    for path, _ in iter_defs(model.cfg):
        t = model.tensor(path).detach().cpu()
        a = (t.view(torch.int16).numpy().view(np.uint16)
             if t.dtype == torch.bfloat16 else t.numpy()).copy()
        if path[0] == "blocks":
            out["blocks"][path[1]][path[2]] = a
        else:
            out[path[0]] = a
    return out
