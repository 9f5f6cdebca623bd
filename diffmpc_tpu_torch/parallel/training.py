"""Imitation-learning training step (counterpart of :mod:`diffmpc_tpu.parallel.training`).

The learner solves a batch of MPC problems with its current model, compares
the controls with an expert's, and takes an optimizer step on the gradient
that flows back through the solve's analytic KKT backward. Single device
only: the data-parallel form over a mesh (``torch.distributed`` with NCCL)
comes with ROADMAP.md, queue 1, item 9.

``torch.optim.Adam`` stands in for ``optax.adam``: its update is the same
rule (bias-corrected moments, ``eps`` added to the corrected second-moment
root, default 1e-8). The learnable params are a tensor or, like the JAX
package's pytree, a nested dict / list / tuple of tensors (an MLP's
``{"w": weights, "b": biases}``). The optimizer is passed as a factory over
the flat list of their leaves, ``optimizer(leaves) ->
torch.optim.Optimizer`` (for example ``functools.partial(torch.optim.Adam,
lr=5e-2)``), and it updates the leaves in place.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..mpc import mpc_solve
from ..types import MPCConfig


class TrainState(NamedTuple):
    params: object  # learnable problem parameters (a tensor or a pytree of them), updated in place
    opt_state: torch.optim.Optimizer


class StepStats(NamedTuple):
    loss: torch.Tensor  # () mean imitation loss
    grad_norm: torch.Tensor  # () global gradient norm over the leaves
    converged_frac: torch.Tensor  # () fraction of converged solves
    qp_residual: torch.Tensor  # () mean solver residual (last improvement)
    clamp_frac: torch.Tensor  # () mean clamped-control fraction


_NO_TASK = object()


def tree_leaves(tree) -> list:
    """The tensors of a nested dict / list / tuple, dicts in sorted key
    order (as JAX flattens them)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``tree`` with every leaf ``x`` replaced by ``fn(x)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


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
    ``params`` may be shared (e.g. ``(3,)``), per scenario (``(B, 3)``) or
    a pytree of tensors.
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
        leaves = tree_leaves(params)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            opt.zero_grad(set_to_none=True)
            for leaf, grad in zip(leaves, grads):
                leaf.grad = grad
            opt.step()
            for leaf in leaves:
                leaf.grad = None
            finite = torch.isfinite(info.last_improvement)
            # optax.global_norm: the norm of the leaves' norms
            norms = [torch.linalg.vector_norm(g) for g in grads]
            stats = StepStats(
                loss.detach(),
                norms[0] if len(norms) == 1 else torch.linalg.vector_norm(torch.stack(norms)),
                info.converged.float().mean(),
                torch.where(finite, info.last_improvement.abs(), 0.0).mean(),
                info.clamp_frac.mean(),
            )
        return TrainState(params, opt), stats

    return step


def init_train_state(params, optimizer: Callable) -> TrainState:
    """Leaf copies of ``params`` (a tensor or a pytree of them) that
    require grad, and the optimizer ``optimizer(leaves)`` over them."""
    params = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    return TrainState(params=params, opt_state=optimizer(tree_leaves(params)))


def generate_expert_data(config: MPCConfig, cost, dx, x_init, u_lower=None, u_upper=None):
    """Run MPC with the true cost and dynamics to make the expert
    trajectories ``(xs, us, objs)``."""
    with torch.no_grad():
        sol = mpc_solve(config, x_init, cost, dx, u_lower=u_lower, u_upper=u_upper)
    return sol.xs, sol.us, sol.objs
