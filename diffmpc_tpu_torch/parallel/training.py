"""Imitation-learning training step (counterpart of :mod:`diffmpc_tpu.parallel.training`).

The learner solves a batch of MPC problems with its current model, compares
the controls with an expert's, and takes an optimizer step on the gradient
that flows back through the solve's analytic KKT backward. Single device
only: the data-parallel form over a mesh (``torch.distributed`` with NCCL)
comes with ROADMAP.md, queue 1, item 9.

``torch.optim.Adam`` stands in for ``optax.adam``: its update is the same
rule (bias-corrected moments, ``eps`` added to the corrected second-moment
root, default 1e-8). The optimizer is passed as a factory over the params
tensor, ``optimizer([params]) -> torch.optim.Optimizer`` (for example
``functools.partial(torch.optim.Adam, lr=5e-2)``), and it updates the
params tensor in place.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..mpc import mpc_solve
from ..types import MPCConfig


class TrainState(NamedTuple):
    params: torch.Tensor  # learnable problem parameters, updated in place
    opt_state: torch.optim.Optimizer


class StepStats(NamedTuple):
    loss: torch.Tensor  # () mean imitation loss
    grad_norm: torch.Tensor  # () gradient norm
    converged_frac: torch.Tensor  # () fraction of converged solves
    qp_residual: torch.Tensor  # () mean solver residual (last improvement)
    clamp_frac: torch.Tensor  # () mean clamped-control fraction


_NO_TASK = object()


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet: data-parallel training comes "
        "with DDP over NCCL (ROADMAP.md, queue 1, item 9)"
    )


def imitation_loss(
    config: MPCConfig,
    params,
    make_problem: Callable,
    x_init: torch.Tensor,
    u_expert: torch.Tensor,
    u_lower=None,
    u_upper=None,
):
    """Mean squared error between the learned model's MPC controls and the
    expert's. ``make_problem(params) -> (cost, dx)`` rebuilds the cost and
    the dynamics from the learnable parameters; the gradient flows through
    the KKT backward of the fixed point only. Returns ``(loss, info)``."""
    cost, dx = make_problem(params)
    sol = mpc_solve(config, x_init, cost, dx, u_lower=u_lower, u_upper=u_upper)
    per_elem = torch.mean((sol.us - u_expert) ** 2, dim=(0, 2))  # (B,)
    return torch.mean(per_elem), sol.info


def make_dp_train_step(
    config: MPCConfig,
    make_problem: Callable,
    optimizer: Callable,
    mesh=None,
    u_lower=None,
    u_upper=None,
    params_batch_axes=None,
    task_batch_axes=_NO_TASK,
):
    """Build the imitation train step
    ``step(state, x_init (B,n), u_expert (T,B,m)) -> (state, StepStats)``.

    ``optimizer`` is the factory that :func:`init_train_state` was given.
    ``params`` may be shared (e.g. ``(3,)``) or per scenario (``(B, 3)``).
    ``mesh``, ``params_batch_axes`` and ``task_batch_axes`` belong to the
    data-parallel form and raise."""
    if mesh is not None:
        raise _unported("a mesh")
    if params_batch_axes is not None:
        raise _unported("params_batch_axes")
    if task_batch_axes is not _NO_TASK:
        raise _unported("task_batch_axes (a per-scenario task payload)")
    del optimizer  # the state carries the optimizer it made

    def step(state: TrainState, x_init, u_expert):
        params, opt = state
        loss, info = imitation_loss(
            config, params, make_problem, x_init, u_expert, u_lower, u_upper
        )
        (grad,) = torch.autograd.grad(loss, params)
        with torch.no_grad():
            opt.zero_grad(set_to_none=True)
            params.grad = grad
            opt.step()
            params.grad = None
            finite = torch.isfinite(info.last_improvement)
            stats = StepStats(
                loss.detach(),
                torch.linalg.vector_norm(grad),
                info.converged.float().mean(),
                torch.where(finite, info.last_improvement.abs(), 0.0).mean(),
                info.clamp_frac.mean(),
            )
        return TrainState(params, opt), stats

    return step


def init_train_state(params: torch.Tensor, optimizer: Callable) -> TrainState:
    """A leaf copy of ``params`` that requires grad, and the optimizer
    ``optimizer([params])`` over it."""
    params = params.detach().clone().requires_grad_(True)
    return TrainState(params=params, opt_state=optimizer([params]))


def generate_expert_data(config: MPCConfig, cost, dx, x_init, u_lower=None, u_upper=None):
    """Run MPC with the true cost and dynamics to make the expert
    trajectories ``(xs, us, objs)``."""
    with torch.no_grad():
        sol = mpc_solve(config, x_init, cost, dx, u_lower=u_lower, u_upper=u_upper)
    return sol.xs, sol.us, sol.objs
