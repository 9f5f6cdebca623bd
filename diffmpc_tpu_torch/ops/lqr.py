"""LQR building blocks (counterpart of :mod:`diffmpc_tpu.ops.lqr`).

``tau_t = [x_t; u_t]``; cost ``sum_t 0.5 tau_t' C_t tau_t + c_t' tau_t``;
dynamics ``x_{t+1} = F_t tau_t + f_t`` (the ``t = T-1`` slice is unused).

- :func:`riccati_backward` and :func:`lqr_linesearch_rollout` keep the JAX
  functions' contracts. On CUDA tensors they launch the hand-written kernels
  (:mod:`~diffmpc_tpu_torch.ops.cuda.riccati`,
  :mod:`~diffmpc_tpu_torch.ops.cuda.rollout`), or their streaming twins
  (:mod:`~diffmpc_tpu_torch.ops.cuda.riccati_stream`,
  :mod:`~diffmpc_tpu_torch.ops.cuda.rollout_stream`) at the horizons where
  the JAX package takes its twins (:mod:`~diffmpc_tpu_torch.ops.cuda.horizon`);
  on CPU tensors they run the kernels' plain PyTorch versions.
- :func:`lqr_rollout` (one step size) and :func:`trajectory_cost` are plain
  PyTorch, and so is the line search through a ``dynamics_fn`` (a model
  without a C++ step) or with a callable cost (``cost_fn``): the JAX
  package's XLA ladder, which has no TPU kernel either.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils.batch import bdot, bmv, bquad, eclamp
from .cuda.horizon import streams_riccati, streams_rollout
from .cuda.ilqr import resolve_use_cuda
from .cuda.riccati import RiccatiResult, riccati_backward_cuda, riccati_backward_plain
from .cuda.riccati_stream import riccati_backward_stream_cuda
from .cuda.rollout import LineSearchResult, linesearch_rollout_cuda, linesearch_rollout_plain
from .cuda.rollout_stream import linesearch_rollout_stream_cuda

__all__ = [
    "LineSearchResult",
    "RiccatiResult",
    "lqr_linesearch_rollout",
    "lqr_rollout",
    "riccati_backward",
    "trajectory_cost",
]


def riccati_backward(
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
    pnqp_iter: int = 20,
    pnqp_enum: str = "",
    value_update_exact_reg: float = -1.0,
    use_cuda: Optional[bool] = None,
) -> RiccatiResult:
    """Riccati backward recursion over ``t = T-1 .. 0`` in one of three
    modes: unconstrained (``u_lower`` None), box (``u_lower, u_upper, u_hat``:
    the box QP on ``[u_lower - u_hat, u_upper - u_hat]`` per step, clamped
    gain rows zeroed) or frozen dims (``ctrl_mask (T,B,m)`` bool, True = held
    at ``du = 0``, the composite KKT backward). ``C (T,B,nm,nm)``,
    ``c (T,B,nm)``, ``F (T,B,n,nm)``, ``f (T,B,n)`` or None (zeros).
    ``pnqp_enum`` is the JAX package's ``DIFFMPC_PNQP_ENUM``, the box QP's
    enumeration mode (``""``, ``"0"`` or ``"1"``).
    ``value_update_exact_reg`` is the JAX package's
    ``VALUE_UPDATE_EXACT_REG``: at or above ``reg``, the simplified value
    update where the inner solve is exact; the default -1 keeps the full
    form.

    The Riccati kernel for CUDA tensors (its streaming twin where
    :func:`~diffmpc_tpu_torch.ops.cuda.horizon.streams_riccati` says so), its
    plain version for CPU tensors (see
    :func:`~diffmpc_tpu_torch.ops.cuda.ilqr.resolve_use_cuda`)."""
    kw = dict(u_lower=u_lower, u_upper=u_upper, u_hat=u_hat, ctrl_mask=ctrl_mask, reg=reg, pnqp_iter=pnqp_iter,
              pnqp_enum=pnqp_enum, value_update_exact_reg=value_update_exact_reg)
    if resolve_use_cuda(use_cuda, C.device):
        if streams_riccati(C.shape[0], n_state, C.shape[-1] - n_state):
            return riccati_backward_stream_cuda(C, c, F, f, n_state, **kw)
        return riccati_backward_cuda(C, c, F, f, n_state, **kw)
    return riccati_backward_plain(C, c, F, f, n_state, **kw)


def lqr_rollout(
    x_init: torch.Tensor,
    F: torch.Tensor,
    f: Optional[torch.Tensor],
    K: torch.Tensor,
    k: torch.Tensor,
    x_hat: Optional[torch.Tensor] = None,
    u_hat: Optional[torch.Tensor] = None,
    alpha=1.0,
    u_lower: Optional[torch.Tensor] = None,
    u_upper: Optional[torch.Tensor] = None,
    delta_u: Optional[float] = None,
    dynamics_fn: Optional[Callable] = None,
):
    """Forward rollout of the affine policy ``u_t = u_hat_t + alpha k_t +
    K_t (x_t - x_hat_t)`` (then the ``delta_u`` clamp, then the box) through
    ``dynamics_fn(x, u)`` when given (the true dynamics, as the iLQR line
    search rolls out) or ``x_{t+1} = F_t tau_t + f_t``. ``x_hat``/``u_hat``
    default to zeros; ``alpha`` is a scalar, ``(B,)``, or any shape that
    broadcasts against ``(B, m)`` from the left, such as ``(A, 1, 1)`` for
    ``A`` rollouts side by side. Returns ``xs (T,...,B,n)`` with
    ``xs[0] = x_init`` and ``us (T,...,B,m)``; differentiable."""
    T, B, m = K.shape[:3]
    if x_hat is None:
        x_hat = torch.zeros((T,) + tuple(x_init.shape), dtype=x_init.dtype, device=x_init.device)
    if u_hat is None:
        u_hat = torch.zeros((T, B, m), dtype=x_init.dtype, device=x_init.device)
    if u_lower is not None:
        u_lower, u_upper = u_lower.expand(T, B, m), u_upper.expand(T, B, m)
    alpha = torch.as_tensor(alpha, dtype=x_init.dtype, device=x_init.device)
    if alpha.ndim == 1:
        alpha = alpha[:, None]  # (B, 1) against the control dim
    x, xs, us = x_init, [], []
    for t in range(T):
        u = u_hat[t] + alpha * k[t] + bmv(K[t], x - x_hat[t])
        if delta_u is not None:
            u = eclamp(u, u_hat[t] - delta_u, u_hat[t] + delta_u)
        if u_lower is not None:
            u = eclamp(u, u_lower[t], u_upper[t])
        x = x.expand(u.shape[:-1] + x.shape[-1:])
        xs.append(x)
        us.append(u)
        if dynamics_fn is not None:
            x = dynamics_fn(x, u)
        else:
            x = bmv(F[t], torch.cat([x, u], -1))
            if f is not None:
                x = x + f[t]
    return torch.stack(xs), torch.stack(us)


def trajectory_cost(
    C: torch.Tensor, c: torch.Tensor, xs: torch.Tensor, us: torch.Tensor
) -> torch.Tensor:
    """Total quadratic cost per batch element: ``(B,)``."""
    tau = torch.cat([xs, us], dim=-1)
    return torch.sum(0.5 * bquad(tau, C) + bdot(c, tau), dim=0)


def lqr_linesearch_rollout(
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
    dynamics_fn: Optional[Callable] = None,
    cost_fn: Optional[Callable] = None,
    decay: float = 0.2,
    max_iter: int = 10,
    use_cuda: Optional[bool] = None,
) -> LineSearchResult:
    """Vectorized backtracking line search: the ladder ``alpha = decay**j``,
    ``j < max_iter``, each scenario taking the first strictly improving step
    over the cost of ``(x_hat, u_hat)``, else the smallest. The dynamics are
    linear (``dyn`` None: ``F, f``), the env ``dyn``'s own C++-backed step,
    or ``dynamics_fn(x, u)``; the cost is the quadratic ``C, c`` or, where
    given, ``cost_fn(xs, us) -> (...)``, a trajectory cost over any leading
    dims (``mpc._make_traj_cost_fn``).

    With ``dyn`` or linear dynamics and the quadratic cost: the rollout
    kernel for CUDA tensors (its streaming twin where
    :func:`~diffmpc_tpu_torch.ops.cuda.horizon.streams_rollout` says so), its
    plain version for CPU tensors (see
    :func:`~diffmpc_tpu_torch.ops.cuda.ilqr.resolve_use_cuda`). With
    ``dynamics_fn`` or ``cost_fn``: the JAX function's ladder in plain
    PyTorch on any device (``diffmpc_tpu/ops/lqr.py:280-356``; the JAX
    package takes it for a callable cost on the TPU as well,
    ``lqr_step.py:204-209``), the ladder's rollouts side by side as a
    leading dim, ``alpha = decay**j`` as powers, through ``F, f`` where
    ``dynamics_fn`` is None."""
    if dynamics_fn is not None or cost_fn is not None:
        return _ladder(x_init, C, c, F, f, K, k, x_hat, u_hat, u_lower, u_upper, delta_u, dynamics_fn, cost_fn,
                       decay, max_iter)
    kw = dict(u_lower=u_lower, u_upper=u_upper, delta_u=delta_u, dyn=dyn, decay=decay, max_iter=max_iter)
    args = (x_init, C, c, F, f, K, k, x_hat, u_hat)
    if resolve_use_cuda(use_cuda, x_init.device):
        T, _, m, n = K.shape
        if streams_rollout(T, n, m):
            return linesearch_rollout_stream_cuda(*args, **kw)
        return linesearch_rollout_cuda(*args, **kw)
    return linesearch_rollout_plain(*args, **kw)


def _ladder(x_init, C, c, F, f, K, k, x_hat, u_hat, u_lower, u_upper, delta_u, dynamics_fn, cost_fn, decay,
            max_iter):
    """The line search through ``dynamics_fn`` (``F, f`` where it is None)
    under ``cost_fn`` (``C, c`` where it is None): every step of the ladder
    rolled out at once, each scenario's first improving one taken."""
    dtype = x_init.dtype
    # a filled tensor, not torch.tensor: an exported program would hold that as a constant
    alphas = torch.full((), decay, dtype=dtype, device=x_init.device) ** torch.arange(
        max_iter, dtype=dtype, device=x_init.device
    )
    xs_l, us_l = lqr_rollout(
        x_init, F, f, K, k, x_hat, u_hat, alpha=alphas[:, None, None],
        u_lower=u_lower, u_upper=u_upper, delta_u=delta_u, dynamics_fn=dynamics_fn,
    )  # (T, A, B, n), (T, A, B, m)
    if cost_fn is None:
        objs_l = trajectory_cost(C[:, None], c[:, None], xs_l, us_l)  # (A, B)
        obj0 = trajectory_cost(C, c, x_hat, u_hat)
    else:
        objs_l, obj0 = cost_fn(xs_l, us_l), cost_fn(x_hat, u_hat)
    improved_l = objs_l < obj0
    has = improved_l.any(0)
    idx = torch.where(has, torch.argmax(improved_l.to(torch.int8), 0), max_iter - 1)
    cols = torch.arange(idx.shape[0], device=idx.device)
    return LineSearchResult(xs_l[:, idx, cols], us_l[:, idx, cols], objs_l[idx, cols], alphas[idx], has)
