"""The streaming twin of the alpha-ladder line search: CUDA kernel wrapper.

Counterpart of
:func:`diffmpc_tpu.ops.pallas.rollout_stream.linesearch_rollout_pallas_stream`,
the TPU kernel the JAX package takes over the resident line search for long
horizons (:mod:`~diffmpc_tpu_torch.ops.cuda.horizon` says when). Like that
kernel it advances the ladder's rollouts and the ``(x_hat, u_hat)`` baseline
together in one pass over the horizon (for an MLP's step, a round of
candidates a pass), and replays the chosen step only where no lane kept it.

- :func:`linesearch_rollout_stream_cuda` launches the kernel of
  ``csrc/rollout_stream.cu`` (the resident kernel's lane groups, with each
  step's slice staged once for the group through shared memory by
  ``cp.async``; L by
  :func:`~diffmpc_tpu_torch.ops.cuda.rollout.rollout_lanes`) on CUDA tensors
  and counts its launches: linear dynamics from ``F, f``, or an env's own
  C++ step. A group whose lanes' first candidates hold the pick reads the
  horizon once. It takes the resident kernel's ``RolloutArgs``, so it
  shares :func:`~diffmpc_tpu_torch.ops.cuda.rollout.run_staged_rollout`.
- Its plain version is the resident line search's,
  :func:`~diffmpc_tpu_torch.ops.cuda.rollout.linesearch_rollout_plain`,
  re-exported here: it already runs the ladder's rollouts side by side, and
  the JAX twin has the resident kernel's contract (``rollout_stream.py:215``).
  The ladder is the rolled one, ``alpha *= decay`` in float32, as in the
  resident kernel; the JAX twin's ``decay**j`` may differ from it by an ulp.
"""

from __future__ import annotations

from typing import Optional

import torch

from .rollout import LineSearchResult, _cuda_launcher, linesearch_rollout_plain, run_on_card

__all__ = ["linesearch_rollout_plain", "linesearch_rollout_stream_cuda"]


def _stream_launcher(device: torch.device, n: int, m: int, dyn):
    return _cuda_launcher(device, n, m, dyn, kind="rollout_stream", counted=linesearch_rollout_stream_cuda)


def linesearch_rollout_stream_cuda(
    x_init: torch.Tensor,
    C: torch.Tensor,
    c: torch.Tensor,
    F: Optional[torch.Tensor],
    f: Optional[torch.Tensor],
    K: torch.Tensor,
    k: torch.Tensor,
    x_hat: torch.Tensor,
    u_hat: torch.Tensor,
    *,
    u_lower: Optional[torch.Tensor] = None,
    u_upper: Optional[torch.Tensor] = None,
    delta_u: Optional[float] = None,
    dyn=None,
    decay: float = 0.2,
    max_iter: int = 10,
) -> LineSearchResult:
    """The line search on the card, streamed: the contract of
    :func:`~diffmpc_tpu_torch.ops.cuda.rollout.linesearch_rollout_cuda`
    (``dyn`` None for the linear dynamics ``F, f``, or a model with a C++
    step).
    CUDA tensors of any float dtype (computed in float32, ``xs, us, objs,
    alpha`` back in ``x_init.dtype``); adds one to
    ``linesearch_rollout_stream_cuda.launches`` and sets its ``last_lanes``;
    other envs raise, and a linear shape or an MLP outside the prebuilt
    kernels builds its variant at first use.
    The JAX twin has no ``unroll``, and neither has this."""
    return run_on_card(
        _stream_launcher, x_init, C, c, F, f, K, k, x_hat, u_hat, u_lower=u_lower, u_upper=u_upper,
        delta_u=delta_u, dyn=dyn, decay=decay, max_iter=max_iter,
    )


linesearch_rollout_stream_cuda.launches = 0  # kernel launches, counted where they happen
linesearch_rollout_stream_cuda.last_lanes = None  # the lane count of the last launch
