"""The streaming twin of the Riccati backward sweep: CUDA kernel wrapper.

Counterpart of
:func:`diffmpc_tpu.ops.pallas.riccati_stream.riccati_backward_pallas_stream`,
the TPU kernel the JAX package takes over the resident sweep for long
horizons (:mod:`~diffmpc_tpu_torch.ops.cuda.horizon` says when).

- :func:`riccati_backward_stream_cuda` launches the kernel of
  ``csrc/riccati_stream.cu`` (the resident kernel's lane groups, each step's
  slice staged once for the group through shared memory by ``cp.async``; L
  by :func:`~diffmpc_tpu_torch.ops.cuda.riccati.riccati_lanes`) on CUDA
  tensors and counts its launches. It takes the resident kernel's
  ``RiccatiArgs``, so it shares
  :func:`~diffmpc_tpu_torch.ops.cuda.riccati.run_staged_riccati`.
- Its plain version is the resident sweep's,
  :func:`~diffmpc_tpu_torch.ops.cuda.riccati.riccati_backward_plain`,
  re-exported here: the twin computes the same function, as the JAX twin has
  the resident kernel's contract (``riccati_stream.py:187``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .riccati import RiccatiResult, _cuda_launcher, riccati_backward_plain, run_on_card

__all__ = ["riccati_backward_plain", "riccati_backward_stream_cuda"]


def _stream_launcher(device: torch.device, n: int, m: int, pnqp_enum: str = ""):
    return _cuda_launcher(device, n, m, kind="riccati_stream", counted=riccati_backward_stream_cuda,
                          pnqp_enum=pnqp_enum)


def riccati_backward_stream_cuda(
    C: torch.Tensor,
    c: torch.Tensor,
    F: torch.Tensor,
    f: Optional[torch.Tensor],
    n_state: int,
    *,
    u_lower: Optional[torch.Tensor] = None,
    u_upper: Optional[torch.Tensor] = None,
    u_hat: Optional[torch.Tensor] = None,
    ctrl_mask: Optional[torch.Tensor] = None,
    reg: float = 1e-9,
    pnqp_iter: int = 8,
    pnqp_enum: str = "",
    value_update_exact_reg: float = -1.0,
) -> RiccatiResult:
    """The Riccati sweep on the card, streamed: the contract of
    :func:`~diffmpc_tpu_torch.ops.cuda.riccati.riccati_backward_cuda`. CUDA
    tensors of any float dtype (computed in float32, ``K, k`` back in
    ``C.dtype``); adds one to ``riccati_backward_stream_cuda.launches`` and
    sets its ``last_lanes`` and ``last_staged``; a shape or mode outside the
    prebuilt kernels builds its variant at first use."""
    return run_on_card(
        _stream_launcher, C, c, F, f, n_state, u_lower=u_lower, u_upper=u_upper, u_hat=u_hat,
        ctrl_mask=ctrl_mask, reg=reg, pnqp_iter=pnqp_iter, pnqp_enum=pnqp_enum,
        value_update_exact_reg=value_update_exact_reg,
    )


riccati_backward_stream_cuda.launches = 0  # kernel launches, counted where they happen
riccati_backward_stream_cuda.last_lanes = None  # the lane count of the last launch
riccati_backward_stream_cuda.last_staged = None  # whether the last launch staged its slices
