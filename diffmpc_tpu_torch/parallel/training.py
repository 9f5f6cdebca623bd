"""Data-parallel imitation-learning training step (counterpart of :mod:`diffmpc_tpu.parallel.training`).

The learner solves a batch of MPC problems with its current model, compares
the controls with an expert's, and takes an optimizer step on the gradient
that flows back through the solve's analytic KKT backward. With a mesh
(:func:`~.mesh.make_mesh`) every rank runs the step on its own shard of the
batch, and the gradient is reduced across ranks by one explicit
``all_reduce``, as the JAX package's ``_reduce_grads`` does inside its
``shard_map``:

- a replicated leaf's gradient is summed over the ranks and divided by the
  world size: the gradient of the global-mean loss;
- a scenario-batched leaf (``params_batch_axes``) keeps its rows on the rank
  that owns their scenarios and is only divided by the world size (its local
  mean becomes the global mean); its rows never cross ranks;
- the loss and the solver statistics are averaged over the ranks, and the
  gradient norm is the global one: the replicated leaves' squares once, plus
  the sum over ranks of the batched leaves' local squares.

``torch.nn.parallel.DistributedDataParallel`` is not used: it averages every
parameter's gradient across ranks, which would mix the rows of
scenario-batched leaves. Every rank applies the same update to the same
replicated gradient, so replicated leaves stay equal on every rank. The JAX
package's two ``check_vma`` modes compute one step; the port has that step
and no such argument.

``torch.optim.Adam`` stands in for ``optax.adam`` (the same rule:
bias-corrected moments, ``eps`` added to the corrected second-moment root)
and ``torch.optim.SGD`` for ``optax.sgd``. The learnable params are a tensor
or, like the JAX package's pytree, a nested dict / list / tuple of tensors.
The optimizer is passed as a factory over the flat list of their leaves,
``optimizer(leaves) -> torch.optim.Optimizer`` (for example
``functools.partial(torch.optim.Adam, lr=5e-2)``), and it updates the leaves
in place.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from ..mpc import mpc_solve
from ..types import MPCConfig
from ..utils.tree import prefix_leaves, tree_leaves, tree_map


class TrainState(NamedTuple):
    params: object  # learnable problem parameters (a tensor or a pytree of them), updated in place
    opt_state: torch.optim.Optimizer


class StepStats(NamedTuple):
    loss: torch.Tensor  # () global mean imitation loss
    grad_norm: torch.Tensor  # () global gradient norm over the leaves
    converged_frac: torch.Tensor  # () fraction of converged solves (global)
    qp_residual: torch.Tensor  # () global mean solver residual (last improvement)
    clamp_frac: torch.Tensor  # () global mean clamped-control fraction


_NO_TASK = object()


def imitation_loss(
    config: MPCConfig,
    params,
    make_problem: Callable,
    x_init: torch.Tensor,
    u_expert: torch.Tensor,
    u_lower=None,
    u_upper=None,
    task=_NO_TASK,
):
    """Mean squared error between the learned model's MPC controls and the
    expert's. ``make_problem(params) -> (cost, dx)`` rebuilds the cost and
    the dynamics from the learnable parameters, or ``make_problem(params,
    task)`` when a per-scenario ``task`` payload is given; the gradient flows
    through the KKT backward of the fixed point only. Returns ``(loss, info)``."""
    cost, dx = make_problem(params) if task is _NO_TASK else make_problem(params, task)
    sol = mpc_solve(config, x_init, cost, dx, u_lower=u_lower, u_upper=u_upper)
    per_elem = torch.mean((sol.us - u_expert) ** 2, dim=(0, 2))  # (B,)
    return torch.mean(per_elem), sol.info


def _is_batched_leaf(a) -> bool:
    """A ``params_batch_axes`` leaf is exactly 0 (scenario-batched) or None
    (replicated); anything else (True, 1, a string) is ambiguous, silently
    wrong one way or the other, and raises."""
    if a is None:
        return False
    if type(a) is int and a == 0:
        return True
    raise ValueError(
        f"params_batch_axes leaves must be 0 (scenario-batched, sharded with the batch) "
        f"or None (replicated); got {a!r}"
    )


def _task_axis(a):
    """A ``task_batch_axes`` leaf: the position of the scenario axis in its
    task leaf (a non-negative int) or None (replicated)."""
    if a is None or (type(a) is int and a >= 0):
        return a
    raise ValueError(
        f"task_batch_axes leaves must be a non-negative int (position of the scenario-batch "
        f"axis) or None (replicated); got {a!r}"
    )


def _check_rows(leaves, axes, batch: int, name: str) -> None:
    """Every scenario-batched leaf has this rank's batch on its axis."""
    for leaf, axis in zip(leaves, axes):
        if axis is not None and leaf.shape[axis] != batch:
            raise ValueError(
                f"{name}: a leaf of shape {tuple(leaf.shape)} has {leaf.shape[axis]} scenarios on "
                f"axis {axis}, the batch {batch}"
            )


def _square_sum(grads, zero: torch.Tensor) -> torch.Tensor:
    """The sum of the squares of every entry of ``grads``, from ``zero`` (a
    0-d tensor of the sum's dtype and device)."""
    return sum((g.to(zero.dtype).square().sum() for g in grads), zero)


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
    ``step(state, x_init (B, n), u_expert (T, B, m)) -> (state, StepStats)``.

    With a ``mesh`` the inputs are this rank's shards (:func:`~.mesh.shard_batch`)
    and the step reduces across the ranks (module docstring); without one
    the same step runs on one device. ``optimizer`` is the factory that
    :func:`init_train_state` was given.

    ``params_batch_axes`` marks the leaves of the params that carry a leading
    scenario axis: None (default), every leaf replicated; 0, every leaf
    scenario-batched (sharded with the batch); or a pytree prefix of the
    params with 0 / None leaves. ``task_batch_axes``, when given, makes the
    step ``step(state, x_init, u_expert, task)`` and calls
    ``make_problem(params, task)``: a non-learnable per-scenario payload
    (goals, setpoints, cost vectors), whose axes prefix gives the position of
    the scenario axis in each task leaf (0 for ``(B, ...)``, 1 for a
    ``(T, B, nm)`` cost vector) or None. Leaves other than these raise
    ``ValueError`` here, with a mesh or without."""
    has_task = task_batch_axes is not _NO_TASK
    tree_map(_is_batched_leaf, params_batch_axes)
    if has_task:
        tree_map(_task_axis, task_batch_axes)
    del optimizer  # the state carries the optimizer it made

    def step(state: TrainState, x_init, u_expert, *task):
        if len(task) != has_task:
            raise TypeError(
                "step(state, x_init, u_expert, task) takes a task exactly when task_batch_axes was given"
            )
        params, opt = state
        B = x_init.shape[0]
        leaves = tree_leaves(params)
        batched = [_is_batched_leaf(a) for a in prefix_leaves(params_batch_axes, params, "params_batch_axes")]
        _check_rows(leaves, [0 if b else None for b in batched], B, "params_batch_axes")
        if has_task:
            _check_rows(tree_leaves(task[0]), prefix_leaves(task_batch_axes, task[0], "task_batch_axes"), B,
                        "task_batch_axes")
        loss, info = imitation_loss(config, params, make_problem, x_init, u_expert, u_lower, u_upper, *task)
        grads = list(torch.autograd.grad(loss, leaves))
        with torch.no_grad():
            finite = torch.isfinite(info.last_improvement)
            stats = [
                loss.detach(),
                info.converged.float().mean(),
                torch.where(finite, info.last_improvement.abs(), 0.0).mean(),
                info.clamp_frac.mean(),
            ]
            dtype = torch.promote_types(loss.dtype, grads[0].dtype)
            zero = torch.zeros((), dtype=dtype, device=loss.device)
            rep = [i for i, b in enumerate(batched) if not b]
            bat = [i for i, b in enumerate(batched) if b]
            if mesh is not None:
                # one all_reduce(SUM) of the replicated gradients, the stats
                # and the batched leaves' local squares, packed together
                world = mesh.size
                for i in bat:
                    grads[i] = grads[i] / world
                packed = torch.cat(
                    [grads[i].reshape(-1).to(dtype) for i in rep]
                    + [torch.stack([s.to(dtype) for s in stats] + [_square_sum([grads[i] for i in bat], zero)])]
                )
                dist.all_reduce(packed, group=mesh.group)
                at = 0
                for i in rep:
                    n = grads[i].numel()
                    grads[i] = (packed[at : at + n] / world).view_as(grads[i]).to(grads[i].dtype)
                    at += n
                stats = [(packed[at + j] / world).to(s.dtype) for j, s in enumerate(stats)]
                bat_sq = packed[-1]
            else:
                bat_sq = _square_sum([grads[i] for i in bat], zero)
            grad_norm = torch.sqrt(_square_sum([grads[i] for i in rep], zero) + bat_sq)
            opt.zero_grad(set_to_none=True)
            for leaf, grad in zip(leaves, grads):
                leaf.grad = grad
            opt.step()
            for leaf in leaves:
                leaf.grad = None
        return TrainState(params, opt), StepStats(stats[0], grad_norm, *stats[1:])

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
