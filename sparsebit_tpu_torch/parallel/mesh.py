"""Device mesh and data-parallel helpers (port of
``sparsebit_tpu/parallel/mesh.py``).

The JAX package builds a ``Mesh`` over the devices one process sees; here
every rank is its own process and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, with the reference's axis names ("dp", "tp", ...). The
group of one axis is ``mesh.get_group(name)``. The default group must
exist first (``multihost.initialize_multihost``): a mesh never starts one
with a backend of its own choosing.
"""

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from sparsebit_tpu_torch import resolve_device
from sparsebit_tpu_torch.llm.convert import map_params, tree_tensors
from sparsebit_tpu_torch.parallel.multihost import (
    initialize_multihost,
    local_batch_slice,
)


def _mesh(device_type, axes):
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call "
                           "parallel.multihost.initialize_multihost first")
    n = math.prod(axes.values())
    have = dist.get_world_size()
    if n > have:
        raise ValueError("need {} devices, have {}".format(n, have))
    device_type = device_type or resolve_device(None).type
    return init_device_mesh(device_type, tuple(axes.values()),
                            mesh_dim_names=tuple(axes))


def make_mesh(dp=1, tp=1, device_type=None):
    """Mesh(("dp", "tp")) over the first dp * tp ranks; ``device_type``
    "cuda" unless the caller names another (raises without CUDA)."""
    return _mesh(device_type, {"dp": dp, "tp": tp})


def make_mesh_named(device_type=None, **axes):
    """Mesh with arbitrary named axes, e.g. make_mesh_named(dp=2, tp=4)."""
    return _mesh(device_type, axes)


def data_parallel_mesh(device):
    """A CLI's data-parallel mesh, ("dp", "tp") with tp = 1: over the world
    that torchrun's variables describe (WORLD_SIZE set; one rank a card,
    initialize_multihost), or None without them, one rank. The
    counterpart of the JAX CLIs' ``make_mesh(dp=len(jax.devices()))``."""
    if "WORLD_SIZE" not in os.environ:
        return None
    _, world = initialize_multihost(device=device)
    return make_mesh(dp=world, device_type=device.type)


def dp_shard_batch(mesh, x):
    """This rank's contiguous rows of a batch sharded over "dp"
    (replicated over the other axes)."""
    return x[local_batch_slice(x.shape[0], mesh)]


@torch.no_grad()
def replicate(mesh, tree):
    """Broadcast every tensor leaf of ``tree`` in place from the mesh's
    first rank (along each axis from its first rank in turn); returns
    ``tree``."""

    def bcast(t):
        if not t.is_contiguous():
            raise ValueError("replicate: leaves must be contiguous")
        for name in mesh.mesh_dim_names:
            g = mesh.get_group(name)
            dist.broadcast(t, src=dist.get_global_rank(g, 0), group=g)
        return t

    map_params(bcast, tree)
    return tree


def sum_grads(tree, mesh, axes=("dp",), mean=False):
    """After ``backward()``: the gradient of every tensor of ``tree`` that
    takes one summed (``mean``: averaged) over the mesh's ``axes``, in
    place; returns ``tree``. The counterpart of the psum that JAX's
    value_and_grad puts on the gradient of an input replicated over those
    axes (``P()``): each rank's backward leaves its share of the loss's
    gradient (parallel/tp.py's collectives section), and the sum makes it
    the whole. A tensor the rank's backward did not reach gets a zero
    gradient first, so that every rank sums the same buffers: one
    all_reduce an axis of the gradients flattened, a dtype at a time."""
    by_dtype = {}
    for t in tree_tensors(tree):
        if not t.requires_grad:
            continue
        if t.grad is None:
            t.grad = torch.zeros_like(t)
        by_dtype.setdefault(str(t.grad.dtype), []).append(t.grad)
    n = math.prod(mesh[a].size() for a in axes)
    for dtype in sorted(by_dtype):
        same = by_dtype[dtype]
        flat = torch.cat([gr.reshape(-1) for gr in same])
        for a in axes:
            dist.all_reduce(flat, group=mesh.get_group(a))
        if mean:
            flat /= n
        for gr, part in zip(same, flat.split([gr.numel() for gr in same])):
            gr.copy_(part.view_as(gr))
    return tree
