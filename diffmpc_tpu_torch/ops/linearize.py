"""Dynamics linearization (counterpart of :mod:`diffmpc_tpu.ops.linearize`).

The fused solve linearizes inside its kernel and needs nothing from here.
:func:`linearize_dynamics` serves the differentiable fixed-point attach of
``mpc_solve``: it linearizes the env once more about the solved trajectory,
in ordinary PyTorch ops, so that autograd carries the KKT backward's
``dF, df`` on to the env's parameters.
"""

from __future__ import annotations

import torch

from ..types import GradMethods
from ..utils.batch import bmv


def linearize_dynamics(dx, xs: torch.Tensor, us: torch.Tensor, method=GradMethods.ANALYTIC):
    """Affine expansion of ``dx`` about a trajectory: ``F_t = [A_t B_t]``
    and ``f_t = dx(x_t, u_t) - F_t tau_t``, so that
    ``x_{t+1} ~= F_t tau_t + f_t``.

    ``xs (T,B,n)``, ``us (T,B,m)`` -> ``(F (T,B,n,n+m), f (T,B,n))``.
    Only ``GradMethods.ANALYTIC`` is ported: the env's closed-form
    ``grad_input``, which is differentiable in the env's params."""
    if method != GradMethods.ANALYTIC:
        raise NotImplementedError(
            f"linearizing with {method} for a gradient is not ported to "
            "PyTorch yet: it comes with the non-fused path (ROADMAP.md, "
            "queue 1, item 3); use GradMethods.ANALYTIC"
        )
    A, B = dx.grad_input(xs, us)
    F = torch.cat([A, B], dim=-1)
    f = dx.forward(xs, us) - bmv(F, torch.cat([xs, us], dim=-1))
    return F, f
