"""The kernel-under-the-mesh probe: CUDA kernel wrapper and plain version.

Counterpart of the Pallas body ``kern`` of tests/test_pallas_sharding.py
(:209-215, ``pallas_call`` at :221), which the JAX package runs on each
device's shard under ``shard_map``: on a shard ``x`` of length ``L`` it
computes ``((x[0] + x[0]) + x[min(1, L-1)]) + x[min(2, L-1)]``, broadcast over
the shard. In the port each rank of a process group calls it on its own
shard (:mod:`diffmpc_tpu_torch.parallel.dryrun`).

- :func:`shard_probe` launches the kernel for a CUDA tensor and runs the
  plain version for a CPU tensor.
- :func:`shard_probe_cuda` launches the kernel of ``csrc/shard_probe.cu`` (a
  grid over the shard) and counts its launches.
- :func:`shard_probe_plain` is the same three float32 adds in PyTorch.
- :func:`launch_floor_cuda` launches an empty kernel: the launch latency
  that bounds the probe, timed beside it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .ilqr import resolve_use_cuda


def _check(x: torch.Tensor) -> int:
    if x.ndim != 1 or x.shape[0] < 1:
        raise ValueError(f"the probe takes one rank's shard, a 1-D tensor of length >= 1; got {tuple(x.shape)}")
    return x.shape[0]


def shard_probe_plain(x: torch.Tensor) -> torch.Tensor:
    """The probe in plain PyTorch, in ``x``'s dtype and on its device."""
    L = _check(x)
    value = ((x[0] + x[0]) + x[min(1, L - 1)]) + x[min(2, L - 1)]
    return value.expand(L).clone()


@functools.lru_cache(maxsize=None)
def _kernels() -> tuple:
    """The probe's and the empty kernel's launchers, resolved once per
    process."""
    from ...csrc import build

    lib = build.load()
    probe, floor = lib.diffmpc_shard_probe, lib.diffmpc_launch_floor
    probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    floor.argtypes = [ctypes.c_void_p]
    probe.restype = floor.restype = ctypes.c_int
    return probe, floor


def _on_device(device: torch.device, launch) -> int:
    """``launch(stream)`` on ``device``'s current stream, its raw handle
    (``torch.cuda.current_stream`` builds a ``Stream`` object each call, a
    large share of a launch-bound wrapper's host time), with ``device`` made
    current only where it is not."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index == torch.cuda.current_device():
        return launch(torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return launch(torch._C._cuda_getCurrentRawStream(index))


def shard_probe_cuda(x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """The probe on the card: a contiguous float32 CUDA tensor, written into
    ``out`` (a new tensor where None; else a contiguous float32 tensor of
    ``x``'s shape on its device, at any offset); adds one to
    ``shard_probe_cuda.launches``."""
    resolve_use_cuda(True, x.device)
    L = _check(x)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"the probe kernel takes a contiguous float32 shard; got {x.dtype}")
    if out is None:
        out = torch.empty_like(x)
    elif out.shape != x.shape or out.dtype != x.dtype or out.device != x.device or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous float32 tensor of shape {tuple(x.shape)} on {x.device}")
    probe, _ = _kernels()
    err = _on_device(x.device, lambda stream: probe(x.data_ptr(), out.data_ptr(), L, stream))
    if err != 0:
        raise RuntimeError(f"shard_probe kernel launch failed: cudaError {err}")
    shard_probe_cuda.launches += 1
    return out


shard_probe_cuda.launches = 0  # kernel launches, counted where they happen


def launch_floor_cuda(device: torch.device) -> None:
    """One empty kernel of one warp on ``device``'s current stream: what a
    launch costs alone, the floor of the probe's time."""
    _, floor = _kernels()
    err = _on_device(device, floor)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: cudaError {err}")


def shard_probe(x: torch.Tensor) -> torch.Tensor:
    """The probe on one rank's shard: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    return shard_probe_cuda(x) if resolve_use_cuda(None, x.device) else shard_probe_plain(x)
