"""Int8 error-feedback gradient compression for cross-pod reduction.

The port's copy of `repro.train.compression`.  At multi-pod scale the
pod-to-pod links are the scarcest bandwidth; the standard mitigation is a
quantized all-reduce with error feedback (the quantization residual is
carried to the next step, so the compression is unbiased over time):

    g_local   -> q8(g_local + err)            (int8 + per-row scale)
    q8 sum over pods (int32 accumulate)       (8x fewer bytes on the link)
    g_hat     -> dequant / n_pods
    err'      = (g_local + err) - g_hat_own_contribution

The reference's two ``psum``s over "pod" inside ``shard_map`` are two
``all_reduce``s on the pod dim's process group; every leaf is replicated
across pods at this point, so each rank works on its own tensor (a
DTensor's local shard).  As in the reference, nothing calls it from the
train step.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.train.tree import leaves, tree_map, unflatten


def _q8(x):
    amax = x.abs().amax(-1, keepdim=True)
    # a tensor divisor: on the card a Python-number divisor becomes a
    # multiply by its reciprocal, an ulp off the reference's division
    scale = torch.where(amax > 0, amax / amax.new_tensor(127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def init_error_buffers(grads_like):
    """float32 zeros shaped like every leaf (DTensor leaves keep their
    layout)."""
    def zeros(g):
        from torch.distributed.tensor import DTensor, zeros as dzeros

        if isinstance(g, DTensor):
            return dzeros(g.shape, dtype=torch.float32,
                          device_mesh=g.device_mesh, placements=g.placements)
        return torch.zeros(g.shape, dtype=torch.float32, device=g.device)

    return tree_map(zeros, grads_like)


def _pod_group(mesh, axis: str):
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None                      # an axis of size 1
    return mesh.get_group(axis)


@torch.no_grad()
def compressed_pod_reduce(grads, err, mesh, axis: str = "pod"):
    """All-reduce ``grads`` over ``axis`` in int8 with error feedback.

    grads: tree of float32 leaves, already reduced within a pod; err:
    matching error-feedback buffers; ``mesh`` a ``DeviceMesh`` (such as a
    :class:`repro_torch.models.sharding.ShardingPolicy`'s refined mesh)
    with an ``axis`` dim; without one (or with None) the pod axis has
    size 1.  Returns
    (reduced_grads, new_err)."""
    from torch.distributed.tensor import DTensor

    group = _pod_group(mesh, axis)
    npods = dist.get_world_size(group) if group is not None else 1

    def leaf(g, e):
        gl = g.to_local() if isinstance(g, DTensor) else g
        el = e.to_local() if isinstance(e, DTensor) else e
        x = gl.float() + el.float()
        q, s = _q8(x)
        qsum = q.to(torch.int32)
        ssum = s.clone()                 # conservative shared scale
        if group is not None:
            dist.all_reduce(qsum, group=group)
            dist.all_reduce(ssum, group=group)
        ghat = qsum.float() * (ssum / npods) / npods
        new_e = x - q.float() * s
        if isinstance(g, DTensor):
            wrap = (lambda t, ref: DTensor.from_local(
                t, ref.device_mesh, ref.placements, run_check=False))
            return wrap(ghat, g), wrap(new_e, e if isinstance(e, DTensor)
                                       else g)
        return ghat, new_e

    out = [leaf(g, e) for g, e in zip(leaves(grads), leaves(err))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))
