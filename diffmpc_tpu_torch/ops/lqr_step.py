"""The differentiable LQR fixed point (counterpart of :mod:`diffmpc_tpu.ops.lqr_step`).

:func:`lqr_fixed_point` is the identity on a converged trajectory
``(x*, u*)``, with the analytic KKT derivatives with respect to
``(x_init, C, c, F, f)``: its backward solves the auxiliary (adjoint) LQR
with tight box dims frozen and assembles the gradients from outer products
of the primal trajectory, the differential trajectory and the multipliers
(the equations are in the JAX module's docstring). The backward is one call
of :func:`~diffmpc_tpu_torch.ops.cuda.kkt.kkt_backward_fused`: the CUDA
kernel on CUDA tensors, its plain PyTorch version on CPU tensors.

Only the fixed point is ported; the solver step ``lqr_step`` and the
composite backward of the non-fused path come with that path (ROADMAP.md,
queue 1, item 3).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from .cuda.kkt import kkt_backward_fused


@dataclasses.dataclass(frozen=True)
class LqrSpec:
    """Static parameters of the differentiable LQR step that its backward
    reads."""

    n_state: int
    constrained: bool = False
    tight_eps: float = 1e-6
    back_eps: float = 1e-7
    # None: the KKT kernel for CUDA tensors, its plain version for CPU
    # tensors (see ops.cuda.ilqr.resolve_use_cuda)
    use_cuda: Optional[bool] = None


class _LqrFixedPoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, x_init, C, c, F, f, x_star, u_star, u_lower, u_upper):
        ctx.spec = spec
        ctx.save_for_backward(C, c, F, x_star, u_star, u_lower, u_upper)
        # outputs must be new tensors: autograd does not let a Function
        # return its inputs unchanged
        return x_star.clone(), u_star.clone()

    @staticmethod
    @once_differentiable
    def backward(ctx, gx, gu):
        spec = ctx.spec
        C, c, F, x_star, u_star, u_lower, u_upper = ctx.saved_tensors
        if spec.constrained:
            tight = (u_star <= u_lower + spec.tight_eps) | (u_star >= u_upper - spec.tight_eps)
        else:
            tight = torch.zeros_like(u_star, dtype=torch.bool)
        gu = torch.where(tight, torch.zeros_like(gu), gu)
        r = torch.cat([gx, gu], dim=-1)
        tau = torch.cat([x_star, u_star], dim=-1)
        dx_init, dC, dc, dF, df = kkt_backward_fused(
            C, c, F, r, tau, tight, reg=spec.back_eps, use_cuda=spec.use_cuda
        )
        # no gradient for the trajectory and the bounds (JAX returns zeros)
        return None, dx_init, dC, dc, dF, df, None, None, None, None


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
    return _LqrFixedPoint.apply(spec, x_init, C, c, F, f, x_star, u_star, u_lower, u_upper)
