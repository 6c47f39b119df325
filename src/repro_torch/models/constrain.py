"""The port's ``with_sharding_constraint``: a layout pinned on a DTensor
activation and on its gradient.

Its own module so that :mod:`repro_torch.models.layers` (the MLP's
hidden) and :mod:`repro_torch.models.model` (every other constraint) use
one function without importing each other.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor


def _placements(x, shardings, name):
    """The placements of the spec named ``name`` for a DTensor ``x``, or
    None (no DTensor, no policy, or no such spec)."""
    if not isinstance(x, DTensor) or shardings is None:
        return None
    spec = shardings.get(name)
    return None if spec is None else shardings["_policy"].placements(spec)


def wsc(x, shardings, name):
    """The reference's ``with_sharding_constraint``: a DTensor is
    redistributed to the placements of the spec named ``name``, and so is
    its gradient (:class:`Constrained`); anything else is returned as it
    is."""
    pl = _placements(x, shardings, name)
    if pl is None:
        return x
    y = x if tuple(x.placements) == pl else x.redistribute(
        x.device_mesh, pl)
    return wsc_grad(y, shardings, name)


def wsc_grad(x, shardings, name):
    """Only the gradient of ``x`` laid out by the spec named ``name``;
    the value keeps the layout its op gave it (where the forward's
    layout is left to DTensor, as GSPMD leaves it, and only the backward
    product needs pinning)."""
    pl = _placements(x, shardings, name)
    if pl is None or not (x.requires_grad and torch.is_grad_enabled()):
        return x
    return Constrained.apply(x, pl)


class Constrained(torch.autograd.Function):
    """The identity on a DTensor, whose gradient is redistributed to
    ``pl``: ``with_sharding_constraint`` constrains the cotangent as it
    constrains the value.  Left to DTensor, a gradient keeps whatever
    layout the ops after the constraint gave it (the Mamba2 gate's
    gradient arrived with its channels whole, split over the tokens, and
    the product for ``w_z``'s gradient ran whole on every model rank)."""

    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.pl:
            g = g.redistribute(g.device_mesh, ctx.pl)
        return g, None
