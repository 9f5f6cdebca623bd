"""Process-group initialization (counterpart of :mod:`diffmpc_tpu.parallel.distributed`).

Every rank runs the same program on its own device. The scenario batch is
cut into contiguous shards, one a rank (:func:`~.mesh.shard_batch`), and the
collectives (the training step's gradient reduction, the gather of results)
are explicit ``torch.distributed`` calls between the kernels, never inside
them. The backend follows the device: NCCL for a card, gloo for the CPU.
NCCL refuses two ranks on one card, so ranks that share a card take
``backend="gloo"``.

A launch with ``torchrun`` (which sets ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT`` and ``LOCAL_RANK`` on every rank)::

    from diffmpc_tpu_torch.parallel import distributed, make_mesh, shard_batch
    distributed.initialize()            # a no-op when run single-process
    mesh = make_mesh()                  # 1-D mesh over every rank
    step = make_dp_train_step(config, make_problem, opt, mesh, lo, hi)
    x_local = ...                       # this rank's shard of the batch
    x = distributed.host_local_to_global(mesh, x_local, batch_dim=0)
    state, stats = step(state, x, u)
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_DEVICE = {}  # the device of the group that initialize() made


def _device(device) -> torch.device:
    """``device``, with a card's index filled in; None is the card
    (``LOCAL_RANK``'s under torchrun), and without a card None raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize: there is no CUDA device; pass device='cpu' to run the "
                "process group on the CPU (gloo)"
            )
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", torch.cuda.current_device())))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _from_env() -> Optional[tuple]:
    """``(init_method, world, rank)`` from torchrun's variables, None when
    none is set; a partial or malformed set raises."""
    env = {k: os.environ.get(k) for k in _ENV}
    if all(v is None for v in env.values()):
        return None
    missing = [k for k, v in env.items() if v is None]
    if missing:
        raise ValueError(
            f"initialize: a partial cluster environment: {missing} unset while "
            f"{[k for k in _ENV if k not in missing]} are set"
        )
    try:
        rank, world, port = int(env["RANK"]), int(env["WORLD_SIZE"]), int(env["MASTER_PORT"])
    except ValueError as e:
        raise ValueError(f"initialize: a malformed cluster environment {env}: {e}") from e
    if not 0 <= rank < world:
        raise ValueError(f"initialize: RANK={rank} is outside WORLD_SIZE={world}")
    return f"tcp://{env['MASTER_ADDR']}:{port}", world, rank


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
    backend: Optional[str] = None,
) -> int:
    """Join the process group; returns this process's rank.

    Explicit arguments assert a multi-process topology, and any
    inconsistency raises, never a silent single-process run:
    ``coordinator_address`` is ``host:port`` (``tcp://``) or a full
    ``init_method`` URL (``file:///path``). Without them the ``torchrun``
    variables are read; when none is set this is a no-op returning 0 (or the
    rank of a group already made), and a partial or malformed set raises.
    Calling it again for the group it made returns the rank; another group
    raises.

    ``device`` is this rank's device: the card by default (without one this
    raises), or ``"cpu"``. ``backend`` defaults to NCCL for a card and gloo
    for the CPU."""
    explicit = (coordinator_address, num_processes, process_id)
    if any(a is not None for a in explicit):
        missing = [k for k, a in zip(("coordinator_address", "num_processes", "process_id"), explicit) if a is None]
        if missing:
            raise ValueError(f"initialize: explicit arguments name a process group, but {missing} are missing")
        if type(num_processes) is not int or num_processes < 1:
            raise ValueError(f"initialize: num_processes must be a positive int; got {num_processes!r}")
        if type(process_id) is not int or not 0 <= process_id < num_processes:
            raise ValueError(f"initialize: process_id {process_id!r} is outside 0..{num_processes - 1}")
        url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        topology = url, num_processes, process_id
    else:
        topology = _from_env()
        if topology is None:
            return dist.get_rank() if dist.is_initialized() else 0
    url, world, rank = topology
    device = _device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if dist.is_initialized():
        made = (dist.get_rank(), dist.get_world_size(), dist.get_backend(), _DEVICE.get("device"))
        if made != (rank, world, backend, device):
            raise RuntimeError(
                f"initialize: a process group (rank, world, backend, device) = {made} exists; "
                f"asked for {(rank, world, backend, device)}"
            )
        return rank
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=url, world_size=world, rank=rank)
    _DEVICE["device"] = device
    return rank


def default_device() -> Optional[torch.device]:
    """The device that :func:`initialize` gave its group, or None."""
    return _DEVICE.get("device")


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE.clear()


def collective_device(group, device) -> torch.device:
    """Where a collective over ``group`` on data of ``device`` runs when the
    caller stages it: on the host for gloo, on ``device`` otherwise."""
    return torch.device("cpu") if dist.get_backend(group) == "gloo" else torch.device(device)


def host_local_to_global(mesh, local, batch_dim: int = 0) -> torch.Tensor:
    """This rank's shard of a batch (a tensor or array that the process
    loaded itself) as a tensor on the mesh's device, after checking that
    every rank's shard has the same shape (the global batch is their
    concatenation along ``batch_dim``, in rank order)."""
    local = torch.as_tensor(local)
    if not 0 <= batch_dim < local.ndim:
        raise ValueError(f"batch_dim {batch_dim} of a {local.ndim}-d shard")
    if local.ndim > 8:
        raise ValueError("host_local_to_global takes shards of at most 8 dimensions")
    shape = torch.full((9,), -1, dtype=torch.int64, device=collective_device(mesh.group, mesh.device))
    shape[0] = local.ndim
    shape[1 : local.ndim + 1] = torch.tensor(local.shape)
    shapes = [torch.empty_like(shape) for _ in range(mesh.size)]
    dist.all_gather(shapes, shape, group=mesh.group)
    if any(not torch.equal(s, shape) for s in shapes):
        raise ValueError(f"the ranks' shards differ in shape: {[s.tolist() for s in shapes]}")
    return local.to(mesh.device).contiguous()
