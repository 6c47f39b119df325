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
devices.

Sharded trees (DTensor leaves): ``save`` gathers each leaf
(``full_tensor()``, on every rank), rank 0 writes, and the others wait
at a barrier; the format is unchanged, so either package restores the
other's checkpoints.  ``restore`` into DTensor leaves keeps each rank's
slice of the stored leaf, whatever layout saved it; ``restore(...,
shardings=)`` (a tree of :class:`repro_torch.models.sharding.Sharding`
matching ``like``) instead returns new DTensor leaves laid out so: the
elastic resharding path onto a mesh from
:func:`repro_torch.launch.elastic.build_mesh`.
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
import torch.distributed as dist

from repro_torch.train.tree import leaves_with_paths, subtree, unflatten

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


def _is_dt(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _multi_rank() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def save(ckpt_dir: str, step: int, tree: PyTree, *,
         extra: Optional[dict] = None, keep_last: int = 3,
         async_write: bool = False):
    """Save a checkpoint.  Returns the final directory path (or the
    writing thread).  In a world of several ranks every rank calls it:
    DTensor leaves are gathered one at a time, rank 0 writes (at once,
    not in a thread) and the others return None after the barrier."""
    writer = not _multi_rank() or dist.get_rank() == 0
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
    host = []
    for path, t in leaves_with_paths(tree):
        full = t.full_tensor() if _is_dt(t) else t
        if writer:
            host.append((_name(path), _dtype_name(full), _to_host(full)))
        del full
    if _multi_rank():
        final = _save_host(ckpt_dir, step, host, extra, keep_last,
                           False) if writer else None
        dist.barrier()
        return final
    return _save_host(ckpt_dir, step, host, extra, keep_last, async_write)


def _save_host(ckpt_dir: str, step: int, host: list, extra, keep_last: int,
               async_write: bool):
    """Write (name, dtype, array) leaves as one committed checkpoint."""
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
def restore(ckpt_dir: str, like: PyTree, *, step: Optional[int] = None,
            shardings: Optional[PyTree] = None):
    """Restore into the tensors of ``like`` (a Model, or a tree of
    tensors such as ``(params, opt_state)``), in place; a DTensor leaf
    takes its own slice of the stored leaf.  With ``shardings`` (a tree
    of :class:`repro_torch.models.sharding.Sharding` shaped as ``like``)
    each leaf is instead laid out anew (``distribute_tensor``; every rank
    reads the file and keeps its slice) and the new tree is returned in
    ``like``'s shape.  Every leaf's shape and dtype is checked against
    the manifest before any is read (ValueError).  Returns (like or the
    new tree, step, extra)."""
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
    from torch.distributed.tensor import distribute_tensor

    placed = []
    for (path, _), (ref, meta) in zip(leaves_with_paths(like), targets):
        arr = np.load(os.path.join(d, meta["file"]))
        t = _from_file(arr, meta["dtype"])
        if shardings is not None:
            sh = subtree(shardings, path)
            dev = ref.device if ref.device.type == sh.mesh.device_type \
                else torch.device(sh.mesh.device_type,
                                  torch.cuda.current_device())
            placed.append(distribute_tensor(t.to(dev), sh.mesh,
                                            sh.placements,
                                            src_data_rank=None))
        elif _is_dt(ref):
            mine = distribute_tensor(t.to(ref.device), ref.device_mesh,
                                     ref.placements, src_data_rank=None)
            ref.to_local().copy_(mine.to_local())
        else:
            ref.copy_(t)
        del arr, t
    if shardings is not None:
        return unflatten(like, placed), step, manifest.get("extra", {})
    return like, step, manifest.get("extra", {})
