"""Fault-tolerant checkpointing in the reference's format.

The port's copy of `repro.train.checkpoint`, so a checkpoint crosses
between the packages in both directions:
  * one ``.npy`` file a leaf plus a JSON manifest (step, ``extra``, and
    each leaf's name, file, shape and dtype); a leaf's name joins its
    path in the reference's pytree order (:mod:`repro_torch.train.tree`),
    so ``(params, opt_state)`` gives ``0_blocks_0_wq`` and
    ``1_blocks_0_wq_m`` as the reference's does;
  * a bfloat16 leaf is stored as its uint16 bits under dtype
    ``"bfloat16"`` (through torch views: no ``ml_dtypes``);
  * atomic commit: write ``<dir>/tmp.<step>.<pid>``, then rename it to
    ``<dir>/step_<step:010d>``; keep-last-K garbage collection;
  * async save: the leaves are copied to the host first, then a
    background thread writes them.

``restore`` writes into the tensors of ``like`` in place, on their
devices; its ``shardings=`` placement belongs to the multi-card slice.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train.tree import leaves_with_paths

PyTree = Any
_MANIFEST = "manifest.json"

def _name(path) -> str:
    return "_".join(str(k) for k in path)


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=t.dtype).numpy().dtype)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """An own host copy (the caller may update ``t`` in place after);
    bfloat16 as its uint16 bits, which numpy can store."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_file(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, tree: PyTree, *,
         extra: Optional[dict] = None, keep_last: int = 3,
         async_write: bool = False):
    """Save a checkpoint.  Returns the final directory path (or the
    writing thread)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    host = [(_name(path), _dtype_name(t), _to_host(t))
            for path, t in leaves_with_paths(tree)]

    def _write():
        tmp = os.path.join(ckpt_dir, f"tmp.{step}.{os.getpid()}")
        final = os.path.join(ckpt_dir, f"step_{step:010d}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "extra": extra or {}, "leaves": []}
        for name, dtype, arr in host:
            fn = f"{name}.npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"].append(
                {"name": name, "file": fn,
                 "shape": list(arr.shape), "dtype": dtype})
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic commit
        _gc(ckpt_dir, keep_last)
        return final

    if async_write:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    return _write()


def _gc(ckpt_dir: str, keep_last: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    for d in os.listdir(ckpt_dir):
        if d.startswith("tmp.") and os.path.isdir(os.path.join(ckpt_dir, d)):
            # stale partial write from a crashed process
            age = time.time() - os.path.getmtime(os.path.join(ckpt_dir, d))
            if age > 3600:
                shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    return steps[-1] if steps else None


@torch.no_grad()
def restore(ckpt_dir: str, like: PyTree, *, step: Optional[int] = None):
    """Restore into the tensors of ``like`` (a Model, or a tree of
    tensors such as ``(params, opt_state)``), in place.  Every leaf's
    shape and dtype is checked against the manifest before any is
    written (ValueError).  Returns (like, step, extra)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    by_name = {m["name"]: m for m in manifest["leaves"]}

    targets = []
    for path, ref in leaves_with_paths(like):
        name = _name(path)
        meta = by_name[name]
        if tuple(meta["shape"]) != tuple(ref.shape):
            raise ValueError(f"shape mismatch for {name}: ckpt "
                             f"{tuple(meta['shape'])} vs {tuple(ref.shape)}")
        if meta["dtype"] != _dtype_name(ref):
            raise ValueError(f"dtype mismatch for {name}: ckpt "
                             f"{meta['dtype']} vs {_dtype_name(ref)}")
        targets.append((ref, meta))
    for ref, meta in targets:
        arr = np.load(os.path.join(d, meta["file"]))
        ref.copy_(_from_file(arr, meta["dtype"]))
    return like, step, manifest.get("extra", {})
