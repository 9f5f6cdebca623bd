"""Dynamics linearization and cost quadraticization (counterpart of
:mod:`diffmpc_tpu.ops.linearize`).

The fused solve linearizes inside its kernel and needs nothing from here.
:func:`linearize_dynamics` serves the non-fused iLQR loop (once per
iteration) and the differentiable fixed-point attach of ``mpc_solve``: it
linearizes the env about a trajectory in ordinary PyTorch ops, so that
autograd carries the KKT backward's ``dF, df`` on to the env's parameters.
:func:`quadraticize_cost` does the same for a callable cost, whose tensors
then receive ``dC, dc``. :func:`check_analytic_grads` is
``GradMethods.ANALYTIC_CHECK``'s check, which ``MPC.solve`` runs.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
from torch.func import grad, hessian, vmap

from ..models.dynamics import Dynamics, autodiff_grad_input
from ..types import GradMethods, LinDx
from ..utils.batch import bmv


def linearize_dynamics(
    dx, xs: torch.Tensor, us: torch.Tensor, method=GradMethods.ANALYTIC, fd_eps: float = 1e-4
) -> LinDx:
    """Affine expansion of ``dx`` about a trajectory: ``F_t = [A_t B_t]``
    and ``f_t = dx(x_t, u_t) - F_t tau_t``, so that
    ``x_{t+1} ~= F_t tau_t + f_t``. A ``LinDx`` is returned as it is.

    ``xs (T,B,n)``, ``us (T,B,m)`` -> ``LinDx(F (T,B,n,n+m), f (T,B,n))``.
    ``GradMethods.ANALYTIC`` (and ``ANALYTIC_CHECK``, whose check is
    ``MPC.solve``'s) takes the model's ``grad_input``, ``AUTO_DIFF`` the
    forward-mode Jacobian of ``forward`` (jointly mapped over per-scenario
    params), ``FINITE_DIFF`` central differences of ``forward`` with step
    ``fd_eps``; each is differentiable in the model's tensors."""
    if isinstance(dx, LinDx):
        return dx
    if method in (GradMethods.ANALYTIC, GradMethods.ANALYTIC_CHECK):
        A, B = dx.grad_input(xs, us)
    elif method == GradMethods.AUTO_DIFF:
        # the base protocol's grad_input is the autodiff one (mapped jointly
        # over per-scenario params), whatever the model overrides it with
        A, B = Dynamics.grad_input(dx, xs, us)
    elif method == GradMethods.FINITE_DIFF:
        A, B = finite_diff_grad_input(dx.forward, xs, us, eps=fd_eps)
    else:
        raise ValueError(method)
    F = torch.cat([A, B], dim=-1)
    f = dx.forward(xs, us) - bmv(F, torch.cat([xs, us], dim=-1))
    return LinDx(F, f)


def finite_diff_grad_input(fwd, x: torch.Tensor, u: torch.Tensor, eps: float = 1e-4):
    """Central-difference Jacobians ``(A (..., n, n), B (..., n, m))`` of
    ``fwd(x, u)``: one batched forward pair per probed dim."""
    n, m = x.shape[-1], u.shape[-1]

    def probe(i, dim, size):
        e = torch.zeros(size, dtype=x.dtype, device=x.device)
        e[i] = eps
        if dim == 0:
            return (fwd(x + e, u) - fwd(x - e, u)) / (2 * eps)
        return (fwd(x, u + e) - fwd(x, u - e)) / (2 * eps)

    A = torch.stack([probe(i, 0, n) for i in range(n)], dim=-1)
    B = torch.stack([probe(i, 1, m) for i in range(m)], dim=-1)
    return A, B


def check_analytic_grads(dx, xs: torch.Tensor, us: torch.Tensor, rtol: float = 1e-3, atol: float = 1e-4) -> None:
    """``GradMethods.ANALYTIC_CHECK``: raise ``AssertionError`` unless the
    model's closed-form Jacobians ``grad_input`` agree with autodiff of its
    ``forward`` (``|analytic - autodiff| <= atol + rtol |autodiff|``
    entrywise), jointly mapped over per-scenario params where the model has
    them."""
    with torch.no_grad():
        A_an, B_an = dx.grad_input(xs, us)
        if getattr(dx, "param_batch_shape", ()):
            A_ad, B_ad = Dynamics.grad_input(dx, xs, us)
        else:
            A_ad, B_ad = autodiff_grad_input(dx.forward, xs, us)
    np.testing.assert_allclose(
        A_an.cpu().numpy(), A_ad.cpu().numpy(), rtol=rtol, atol=atol,
        err_msg="analytic A (d x_next / d x) disagrees with autodiff",
    )
    np.testing.assert_allclose(
        B_an.cpu().numpy(), B_ad.cpu().numpy(), rtol=rtol, atol=atol,
        err_msg="analytic B (d x_next / d u) disagrees with autodiff",
    )


def quadraticize_cost(
    cost_fn: Callable, xs: torch.Tensor, us: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Second-order expansion of a scalar cost ``cost_fn(tau)`` (``tau`` one
    ``(n+m,)`` sample) about a trajectory, in the solver's absolute form:
    ``C_t = H(tau_t)`` and ``c_t = g(tau_t) - H(tau_t) tau_t``, so that
    ``0.5 tau' C tau + c' tau`` has the cost's gradient and Hessian at
    ``tau_t``. ``xs (T,B,n)``, ``us (T,B,m)`` -> ``(C (T,B,nm,nm),
    c (T,B,nm))``: ``torch.func``'s ``grad`` and ``hessian`` mapped over the
    ``T * B`` samples, differentiable in the tensors ``cost_fn`` closes
    over."""
    tau = torch.cat([xs, us], -1)
    T, B, nm = tau.shape
    flat = tau.reshape(-1, nm)
    g = vmap(grad(cost_fn))(flat).reshape(T, B, nm)
    H = vmap(hessian(cost_fn))(flat).reshape(T, B, nm, nm)
    return H, g - bmv(H, tau)

