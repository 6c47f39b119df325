"""Process group and device meshes.

The port's copy of `repro.launch.mesh` over ``torch.distributed``: a
``DeviceMesh`` with named dims takes the place of ``jax.sharding.Mesh``.
Every rank of the world runs the same program (SPMD) and builds the same
meshes.

:func:`init_distributed` starts the process group, from torchrun's
``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` or from an explicit ``store=``
(e.g. a ``FileStore``), and picks the backend from the hardware: NCCL
when every rank has a card of its own, gloo on the CPU.  The meshes'
device type follows the device asked for (default: the card, as
:mod:`repro_torch.device` says).
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def pick_backend(dev: torch.device, world_size: int) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    if (dev.type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= world_size):
        return "nccl"
    return "gloo"


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` when it names a card's index (or
    is not a card), else the card ``cuda:LOCAL_RANK`` (torchrun's local
    rank, 0 without it) modulo the cards present.  ``None`` means the
    card and raises without one."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                            % max(torch.cuda.device_count(), 1))
    return resolve_device(dev)


def init_distributed(device=None, *, store=None, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     backend: Optional[str] = None,
                     verbose: bool = True) -> torch.device:
    """Start the default process group (once) and return this rank's
    device (:func:`rank_device`).  Without ``store``, torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/
    ``MASTER_PORT``) is read; without either, a world of one is started
    over a private ``HashStore``."""
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    if store is None and "RANK" not in os.environ:
        store, rank, world_size = dist.HashStore(), 0, 1
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    backend = backend or pick_backend(dev, world_size)
    kw = dict(backend=backend, rank=rank, world_size=world_size)
    if store is not None:
        kw["store"] = store
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    if verbose and rank == 0:
        print(f"torch.distributed: world {world_size}, backend {backend}, "
              f"device {dev.type}")
    return dev


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device=None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    first prod(shape) ranks of the started world; raises, naming the world
    it needs, when the world differs."""
    from torch.distributed.device_mesh import DeviceMesh

    need = math.prod(shape)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    if world != need:
        raise RuntimeError(
            f"mesh {dict(zip(axes, shape))} needs a world of {need} ranks, "
            f"the launched world has {world} (start it with torchrun "
            f"--nproc-per-node / --nnodes so that WORLD_SIZE={need})")
    dev = init_distributed(device)
    ranks = torch.arange(need).reshape(shape)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's (16, 16) ("data", "model") mesh, or (2, 16, 16)
    with "pod" first: 256 or 512 ranks."""
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    axes = MULTI_POD_AXES if multi_pod else PRODUCTION_AXES
    resolve_device(device)
    return make_mesh(shape, axes, device=device)


def make_host_mesh(device=None):
    """A (1, 1) ("data", "model") mesh: a world of one."""
    return make_mesh((1, 1), PRODUCTION_AXES, device=device)


def launch_mesh(production: bool, shape: Optional[str], device=None):
    """The mesh a launcher's flags ask for: the production mesh, a
    ``--mesh`` shape "D,M" or "P,D,M" over the launched world, or None
    (one device).  A world of several ranks asks for one of the two."""
    if production:
        return make_production_mesh(device=device)
    if not shape:
        world = int(os.environ.get("WORLD_SIZE", 1))
        if world > 1:
            raise RuntimeError(
                f"a world of {world} ranks needs --mesh D,M (or P,D,M) or "
                f"--production-mesh")
        return None
    dims = tuple(int(a) for a in shape.split(","))
    return make_mesh(dims, MULTI_POD_AXES if len(dims) == 3
                     else PRODUCTION_AXES, device=device)
