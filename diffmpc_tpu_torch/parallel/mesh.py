"""The 1-D mesh and the sharding helpers (counterpart of :mod:`diffmpc_tpu.parallel.mesh`).

A :class:`Mesh` is the process group, this rank, the world size and this
rank's device, with the name of its one axis. A batch is sharded as
contiguous slices, rank ``r`` holding rows ``[r L, (r+1) L)`` of ``L = B /
world``; every shard is a plain local tensor on the rank's device, so the
kernels take plain pointers, and the collectives are explicit calls.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from ..utils.tree import prefix_leaves, tree_leaves, tree_map
from . import distributed

BATCH_AXIS = "batch"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the ranks of ``group``."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = BATCH_AXIS


def make_mesh(device=None, axis: str = BATCH_AXIS) -> Mesh:
    """The 1-D mesh over every rank of the process group, named ``axis``.
    ``device`` defaults to the one :func:`~.distributed.initialize` chose. The
    group must exist: without one this raises, never a silent
    single-process mesh."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call parallel.distributed.initialize() first")
    if device is None:
        device = distributed.default_device()
        if device is None:
            raise ValueError("make_mesh: the process group was not made by initialize(); pass its device")
    group = dist.group.WORLD
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), torch.device(device), axis)


def batch_sharding(mesh: Mesh, batch_dim: int = 0, ndim: int = 2) -> Shard:
    """The placement of a tensor sharded on ``batch_dim`` (``(T, B, ...)``
    trajectories: 1; ``(B, ...)`` scenario tensors: 0)."""
    if not 0 <= batch_dim < ndim:
        raise ValueError(f"batch_dim {batch_dim} of a {ndim}-d tensor")
    return Shard(batch_dim)


def replicated(mesh: Mesh) -> Replicate:
    """The placement of a tensor every rank holds whole."""
    return Replicate()


def shard_batch(mesh: Mesh, tree, batch_dim: int = 0):
    """This rank's contiguous slice of every leaf of ``tree`` (tensors or
    arrays holding the whole batch on ``batch_dim``), on the mesh's device.
    A batch that does not divide evenly over the ranks raises ``ValueError``,
    as ``shard_map`` does."""

    def take(x):
        x = torch.as_tensor(x)
        n = x.shape[batch_dim]
        if n % mesh.size:
            raise ValueError(f"a batch of {n} on dim {batch_dim} does not divide evenly over {mesh.size} ranks")
        L = n // mesh.size
        return x.narrow(batch_dim, mesh.rank * L, L).to(mesh.device).contiguous()

    return tree_map(take, tree)


def replicate(mesh: Mesh, tree):
    """Every leaf of ``tree`` on every rank as rank 0 holds it, on the
    mesh's device (a broadcast from rank 0)."""

    def put(x):
        x = torch.as_tensor(x).to(mesh.device).clone()
        dist.broadcast(x, 0, group=mesh.group)
        return x

    return tree_map(put, tree)


def gather_results(tree, batch_dim=0, mesh: Mesh = None):
    """The whole batch of every leaf as host numpy arrays: each rank's shard
    concatenated in rank order on its batch dim (``batch_dim``: an int, or a
    pytree prefix of ``tree`` whose leaves are ints, or None for a leaf every
    rank holds whole, returned as this rank has it). Every rank gets the
    whole batch. Without a process group each leaf is copied to the host as
    it is. The one function of the port whose contract is the host."""
    group = mesh.group if mesh is not None else dist.group.WORLD
    leaves = tree_leaves(tree)
    dims = prefix_leaves(batch_dim, tree, "batch_dim")
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    out = []
    for x, dim in zip(leaves, dims):
        x = torch.as_tensor(x).detach()
        if world > 1 and dim is not None:
            x = x.to(distributed.collective_device(group, x.device)).contiguous()
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x, group=group)
            x = torch.cat(parts, dim)
        out.append(x.cpu().numpy())
    it = iter(out)
    return tree_map(lambda _: next(it), tree)
