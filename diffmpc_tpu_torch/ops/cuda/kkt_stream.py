"""The streaming twin of the fused KKT backward: CUDA kernel wrapper.

Counterpart of :func:`diffmpc_tpu.ops.pallas.kkt_stream.kkt_backward_fused_stream`,
the TPU kernel the JAX package takes for the backward of long horizons
(:func:`~diffmpc_tpu_torch.ops.cuda.horizon.streams_kkt` says when;
:func:`~diffmpc_tpu_torch.ops.cuda.kkt.kkt_backward_fused` routes there).

- :func:`kkt_backward_stream_cuda` launches the kernel of
  ``csrc/kkt_stream.cu`` on CUDA tensors and counts its launches: the
  resident kernel's lane groups (``csrc/kkt.cuh``: a group of L threads per
  scenario, each step's slice staged for the group through a ring of
  shared-memory slots by ``cp.async``) with ``K, k, p`` kept in device
  memory between the sweeps, as the TPU twin keeps them. It takes the
  resident kernel's ``KktArgs`` and lane rule, so it shares
  :func:`~diffmpc_tpu_torch.ops.cuda.kkt.run_staged_kkt`.
- Its plain version is the resident kernel's,
  :func:`~diffmpc_tpu_torch.ops.cuda.kkt.kkt_backward_plain`, re-exported
  here: the twin computes the same function, as the JAX twin has the
  resident kernel's contract (``kkt_stream.py:214``).
"""

from __future__ import annotations

import torch

from .kkt import _cuda_launcher, kkt_backward_plain, run_on_card

__all__ = ["kkt_backward_plain", "kkt_backward_stream_cuda"]


def _stream_launcher(device: torch.device, n: int, m: int, exact: bool = False):
    return _cuda_launcher(device, n, m, kind="kkt_backward_stream", counted=kkt_backward_stream_cuda, exact=exact)


def kkt_backward_stream_cuda(C, c, F, r, tau, tight, *, reg: float = 1e-7, value_update_exact_reg: float = -1.0):
    """The KKT backward on the card, streamed: the contract of
    :func:`~diffmpc_tpu_torch.ops.cuda.kkt.kkt_backward_fused`. CUDA tensors
    of any float dtype (computed in float32, the gradients back in
    ``C.dtype``); adds one to ``kkt_backward_stream_cuda.launches``; a shape
    outside the prebuilt table, or the simplified value update, builds its
    variant at first use."""
    return run_on_card(_stream_launcher, C, c, F, r, tau, tight, reg=reg,
                       value_update_exact_reg=value_update_exact_reg)


kkt_backward_stream_cuda.launches = 0  # kernel launches, counted where they happen
kkt_backward_stream_cuda.last_lanes = None  # the lane count of the last launch
kkt_backward_stream_cuda.last_on_chip = None  # always False: the twin keeps K, k and p in device memory
