"""The differentiable LQR step (counterpart of :mod:`diffmpc_tpu.ops.lqr_step`).

- :func:`lqr_step` is the solver step of the non-fused iLQR loop: the
  delta-form cost about the current trajectory, the Riccati sweep (the box
  QP per step when box-constrained) and the line-searched rollout, each one
  launch of its kernel on CUDA tensors (its plain version on CPU tensors);
  for a model without a kernel step, or a callable cost, the line search is
  plain PyTorch.
  At the horizons where the JAX package takes its streaming twins
  (:mod:`~diffmpc_tpu_torch.ops.cuda.horizon`), each is one launch of the
  twin.
- :func:`lqr_fixed_point` is the identity on a converged trajectory
  ``(x*, u*)``, with the analytic KKT derivatives with respect to
  ``(x_init, C, c, F, f)``: its backward solves the auxiliary (adjoint) LQR
  with tight box dims frozen and assembles the gradients from outer products
  of the primal trajectory, the differential trajectory and the multipliers
  (the equations are in the JAX module's docstring). It is the
  ``diffmpc::lqr_fixed_point`` op (:mod:`~diffmpc_tpu_torch.ops.library`),
  whose backward is one ``diffmpc::kkt_backward`` op: the KKT kernel, or its
  streaming twin at long horizons.
- :func:`kkt_backward_composite` computes the same backward from the
  mask-mode Riccati sweep and :func:`~diffmpc_tpu_torch.ops.lqr.lqr_rollout`
  (the JAX package's ``_kkt_backward_impl``). Nothing on the solve's path
  calls it: the JAX package takes it only by a TPU memory budget. It is an
  independent check of the KKT kernel.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..utils.batch import bger, bmv, btrans
from . import library
from .lqr import lqr_linesearch_rollout, lqr_rollout, riccati_backward


@dataclasses.dataclass(frozen=True)
class LqrSpec:
    """Static parameters of the differentiable LQR step."""

    n_state: int
    constrained: bool = False
    tight_eps: float = 1e-6
    back_eps: float = 1e-7
    reg: float = 1e-9
    pnqp_iter: int = 20
    # the box QP's enumeration mode and the simplified value update's
    # threshold (MPCConfig.pnqp_enum, MPCConfig.value_update_exact_reg)
    pnqp_enum: str = ""
    value_update_exact_reg: float = -1.0
    linesearch_decay: float = 0.2
    max_linesearch_iter: int = 10
    delta_u: Optional[float] = None
    # None: the kernels for CUDA tensors, their plain versions for CPU
    # tensors (see ops.cuda.ilqr.resolve_use_cuda)
    use_cuda: Optional[bool] = None


def _riccati(spec: LqrSpec, C, c, F, f, n_state, **kwargs):
    """The Riccati sweep of the step: on CUDA tensors the kernel, or its
    streaming twin where the JAX package takes its twin
    (:func:`~diffmpc_tpu_torch.ops.cuda.horizon.streams_riccati`); the plain
    version on CPU tensors."""
    return library.riccati_backward(C, c, F, f, n_state, use_cuda=spec.use_cuda, **kwargs)


class LqrStepResult(NamedTuple):
    xs: torch.Tensor
    us: torch.Tensor
    objs: torch.Tensor
    alpha: torch.Tensor
    improved: torch.Tensor
    free_mask: torch.Tensor  # (T, B, m)
    n_qp_iter: torch.Tensor  # (T, B)


def lqr_step(
    spec: LqrSpec,
    x_init: torch.Tensor,
    C: torch.Tensor,
    c: torch.Tensor,
    F: torch.Tensor,
    f: Optional[torch.Tensor],
    x_hat: torch.Tensor,
    u_hat: torch.Tensor,
    u_lower: Optional[torch.Tensor] = None,
    u_upper: Optional[torch.Tensor] = None,
    dyn=None,
    cost_fn=None,
) -> LqrStepResult:
    """One LQR / box-DDP step about ``(x_hat, u_hat)``: the delta-form cost
    (``C`` and ``c + C tau_hat``), the Riccati sweep (box mode when
    ``u_lower`` is given, a kernel on CUDA tensors) and the line-searched
    rollout through the linear dynamics ``F, f`` (``dyn`` None) or the model
    ``dyn``. A model with an ``entries_step`` that may run inside a kernel
    takes the rollout kernel with its step (the JAX package's ``fusable``
    rule, ``lqr_step.py:206-209``); any other takes the ladder through its
    ``forward`` in plain PyTorch, as the JAX package takes its XLA ladder.
    With ``cost_fn(xs, us) -> (B,)``, a callable cost lifted to the
    trajectory (``C, c`` its quadraticization about ``(x_hat, u_hat)``),
    the line search judges each step by ``cost_fn`` and takes the plain
    ladder on every device: the JAX package's dispatch (``cost_fn is None``
    gates its kernel), not a fallback."""
    fusable = cost_fn is None and (
        dyn is None or (hasattr(dyn, "entries_step") and getattr(dyn, "kernel_fusable", True))
    )
    n = spec.n_state
    tau_hat = torch.cat([x_hat, u_hat], -1)
    c_delta = c + bmv(C, tau_hat)
    res = _riccati(
        spec, C, c_delta, F, None, n,
        u_lower=u_lower, u_upper=u_upper, u_hat=u_hat if u_lower is not None else None,
        reg=spec.reg, pnqp_iter=spec.pnqp_iter, pnqp_enum=spec.pnqp_enum,
        value_update_exact_reg=spec.value_update_exact_reg,
    )
    kw = dict(u_lower=u_lower, u_upper=u_upper, delta_u=spec.delta_u, decay=spec.linesearch_decay,
              max_iter=spec.max_linesearch_iter, use_cuda=spec.use_cuda)
    if fusable:
        ls = library.linesearch_rollout(x_init, C, c, F, f, res.K, res.k, x_hat, u_hat, dyn=dyn, **kw)
    else:
        ls = lqr_linesearch_rollout(x_init, C, c, F, f, res.K, res.k, x_hat, u_hat,
                                    dynamics_fn=None if dyn is None else dyn.forward, cost_fn=cost_fn, **kw)
    return LqrStepResult(ls.xs, ls.us, ls.objs, ls.alpha, ls.improved, res.free_mask, res.n_qp_iter)


def kkt_backward_composite(C, c, F, r, tau, tight, *, reg: float = 1e-7, value_update_exact_reg: float = -1.0,
                           use_cuda: Optional[bool] = None):
    """The KKT backward of :func:`lqr_fixed_point` from its parts, with the
    contract of :func:`~diffmpc_tpu_torch.ops.cuda.kkt.kkt_backward_fused`:
    the auxiliary LQR ``min 0.5 p'C p + r'p`` with the ``tight`` dims frozen
    (the Riccati sweep in mask mode), its zero-residual rollout ``p`` from
    ``p_x0 = 0``, and the multiplier recursions
    ``lam_t = -(C_t tau_t + c_t)_x + F_{t,x}' lam_{t+1}`` and
    ``mu_t = -(C_t p_t + r_t)_x + F_{t,x}' mu_{t+1}``. Returns
    ``(dx_init, dC, dc, dF, df)``."""
    T, B, nm = c.shape
    m = tight.shape[-1]
    n = nm - m
    aux = riccati_backward(C, r, F, None, n, ctrl_mask=tight, reg=reg, value_update_exact_reg=value_update_exact_reg,
                           use_cuda=use_cuda)
    zeros = torch.zeros((B, n), dtype=aux.K.dtype, device=C.device)
    p_x, p_u = lqr_rollout(zeros, F, None, aux.K, aux.k)
    p = torch.cat([p_x, p_u], -1)
    dC = 0.5 * (bger(p, tau) + bger(tau, p))
    Fx_T = btrans(F[..., :n])  # (T, B, n, n)

    def multipliers(lin, traj):
        """``lam_t`` for t = T-1..0 from ``lam_T = 0``: returns ``lam_0``
        and the sequence ``lam_{t+1}`` (zero at t = T-1)."""
        lam = torch.zeros_like(zeros)
        nxt = [None] * T
        for t in reversed(range(T)):
            nxt[t] = lam
            lam = -(bmv(C[t], traj[t]) + lin[t])[..., :n] + bmv(Fx_T[t], lam)
        return lam, torch.stack(nxt)

    _, lam_next = multipliers(c, tau)
    mu_0, mu_next = multipliers(r, p)
    dF = -(bger(mu_next, tau) + bger(lam_next, p))
    return -mu_0, dC, p, dF, -mu_next


def lqr_fixed_point(
    spec: LqrSpec,
    x_init: torch.Tensor,
    C: torch.Tensor,
    c: torch.Tensor,
    F: torch.Tensor,
    f: torch.Tensor,
    x_star: torch.Tensor,
    u_star: torch.Tensor,
    u_lower: torch.Tensor,
    u_upper: torch.Tensor,
):
    """Identity on the converged trajectory ``x_star (T,B,n)``,
    ``u_star (T,B,m)``, with analytic KKT derivatives with respect to
    ``x_init (B,n)``, ``C (T,B,nm,nm)``, ``c (T,B,nm)``, ``F (T,B,n,nm)``
    and ``f (T,B,n)``. ``u_lower``/``u_upper`` broadcast to ``u_star``
    (``+-inf`` with ``spec.constrained=False`` when unconstrained)."""
    u_lower = torch.broadcast_to(u_lower, u_star.shape)
    u_upper = torch.broadcast_to(u_upper, u_star.shape)
    return library.lqr_fixed_point(
        x_init, C, c, F, f, x_star, u_star, u_lower, u_upper, constrained=spec.constrained,
        tight_eps=spec.tight_eps, back_eps=spec.back_eps, value_update_exact_reg=spec.value_update_exact_reg,
        use_cuda=spec.use_cuda,
    )
