"""The kernel-under-the-mesh probe: CUDA kernel wrapper and plain version.

Counterpart of the Pallas body ``kern`` of tests/test_pallas_sharding.py
(:209-215, ``pallas_call`` at :221), which the JAX package runs on each
device's shard under ``shard_map``: on a shard ``x`` of length ``L`` it
computes ``((x[0] + x[0]) + x[min(1, L-1)]) + x[min(2, L-1)]``, broadcast over
the shard. In the port each rank of a process group calls it on its own
shard (:mod:`diffmpc_tpu_torch.parallel.dryrun`).

- :func:`shard_probe` launches the kernel for a CUDA tensor and runs the
  plain version for a CPU tensor.
- :func:`shard_probe_cuda` launches the kernel of ``csrc/shard_probe.cu`` (one
  thread block per shard) and counts its launches.
- :func:`shard_probe_plain` is the same three float32 adds in PyTorch.
"""

from __future__ import annotations

import ctypes

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


def shard_probe_cuda(x: torch.Tensor) -> torch.Tensor:
    """The probe on the card: a contiguous float32 CUDA tensor; adds one to
    ``shard_probe_cuda.launches``."""
    resolve_use_cuda(True, x.device)
    L = _check(x)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"the probe kernel takes a contiguous float32 shard; got {x.dtype}")
    from ...csrc import build

    fn = build.load().diffmpc_shard_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), L, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"shard_probe kernel launch failed: cudaError {err}")
    shard_probe_cuda.launches += 1
    return out


shard_probe_cuda.launches = 0  # kernel launches, counted where they happen


def shard_probe(x: torch.Tensor) -> torch.Tensor:
    """The probe on one rank's shard: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    return shard_probe_cuda(x) if resolve_use_cuda(None, x.device) else shard_probe_plain(x)
