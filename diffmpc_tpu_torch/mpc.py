"""MPC orchestration of the PyTorch port (counterpart of :mod:`diffmpc_tpu.mpc`).

Two paths, chosen as the JAX package chooses (:func:`_would_use_fused`):

- **fused**: QuadCost + box bounds + a model with a kernel-fusable
  ``entries_step`` (the zoo's envs, a small ``NNDynamics``, either wrapped
  in ``CtrlPassthroughDynamics`` by the slew penalty), no finite
  differences and no printing: the whole solve is one call of
  :func:`diffmpc_tpu_torch.ops.cuda.ilqr.ilqr_solve_fused`;
- **non-fused**: everything else (``LinDx`` dynamics, forward-only models
  such as ``AffineDynamics`` or a large ``NNDynamics``, unconstrained
  problems, callable costs, ``verbose > 0``, ``GradMethods.FINITE_DIFF``):
  the masked iLQR loop around
  :func:`diffmpc_tpu_torch.ops.lqr_step.lqr_step`, one launch of the
  Riccati kernel per iteration and one of the rollout kernel for linear or
  kernel-fusable dynamics under a quadratic cost (of their streaming twins
  at the horizons where the JAX package takes those,
  :mod:`diffmpc_tpu_torch.ops.cuda.horizon`), or the ladder in plain
  PyTorch for the others, and one read of the ``done`` mask on the host to
  stop early. A callable cost is quadraticized about the trajectory once
  an iteration (:func:`~diffmpc_tpu_torch.ops.linearize.quadraticize_cost`).

``slew_rate_penalty`` solves the control-augmented problem (state
``[u_prev; x]``, :func:`_augment_slew`) on the same two paths. ``u_zero_I``
is the degenerate box ``lo = hi = 0`` on its dims. Kernels run on CUDA
tensors, their plain PyTorch versions on CPU tensors.

The gradient: with ``backprop=True``, grad mode on and any of ``x_init``,
the cost's ``C``/``c``, the ``LinDx`` arrays or any tensor of the model
(the env's ``params``, an MLP's weights and biases) requiring grad, or a
callable cost (whose tensors cannot be seen from here), the solved
trajectory is attached to the inputs through
:func:`diffmpc_tpu_torch.ops.lqr_step.lqr_fixed_point`, whose backward is
the KKT kernel (the plain version on CPU tensors), about the model
linearized once more at the solution. Otherwise the solve returns its
trajectory as it is, and the attach costs nothing.

Every kernel, the fixed point and the linearization are called through
their ops (:mod:`diffmpc_tpu_torch.ops.library`), the calls that an
exported program (:mod:`diffmpc_tpu_torch.aot`) records.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Union

import torch
from torch._higher_order_ops.while_loop import while_loop_op
from torch.func import vmap
from torch.nn.functional import pad

from .models import spec as model_spec
from .ops.library import ilqr_solve_fused, linearize, rollout
from .ops.linearize import check_analytic_grads, distinct_tensors, quadraticize_cost
from .ops.lqr import trajectory_cost
from .ops.lqr_step import LqrSpec, lqr_fixed_point, lqr_step
from .models.dynamics import CtrlPassthroughDynamics, Dynamics
from .types import GradMethods, LinDx, MPCConfig, QuadCost

CostLike = Union[QuadCost, Callable]


class MPCInfo(NamedTuple):
    """Per-solve statistics."""

    converged: torch.Tensor  # (B,) bool: improvement dropped below eps
    n_iters: torch.Tensor  # () int32: iLQR iterations run (until all froze)
    last_improvement: torch.Tensor  # (B,)
    mean_alpha: torch.Tensor  # (B,) line-search step of the last iteration
    clamp_frac: torch.Tensor  # (B,) fraction of control entries at a bound
    qp_iters: torch.Tensor  # (B,) mean box-QP solves per step (1.0: direct)


class MPCSolution(NamedTuple):
    xs: torch.Tensor  # (T, B, n)
    us: torch.Tensor  # (T, B, m)
    objs: torch.Tensor  # (B,)
    info: MPCInfo


def _symmetric_cost(cost: QuadCost, dtype, device) -> QuadCost:
    """``cost`` as tensors of ``dtype`` on ``device``, C symmetrized: the
    kernels mirror its upper triangle, so the full-C stage cost must see the
    same problem."""
    C = torch.as_tensor(cost.C, dtype=dtype, device=device)
    c = torch.as_tensor(cost.c, dtype=dtype, device=device)
    return QuadCost(0.5 * (C + C.transpose(-1, -2)), c)


def _expand_cost(cost: QuadCost, T: int, B: int, dtype, device) -> QuadCost:
    """Accept C of ndim 2 ``(nm, nm)``, 3 ``(T, nm, nm)`` or 4
    ``(T, B, nm, nm)``, and c of ndim 1/2/3 accordingly. A C or c shared
    over the batch (or the horizon) comes back expanded as a view."""
    C, c = _symmetric_cost(cost, dtype, device)
    if C.ndim == 2:
        C = C[None, None]
    elif C.ndim == 3:
        C = C[:, None]
    C = C.expand((T, B) + tuple(C.shape[-2:]))
    if c.ndim == 1:
        c = c[None, None]
    elif c.ndim == 2:
        c = c[:, None]
    c = c.expand(T, B, c.shape[-1])
    return QuadCost(C, c)


def _expand_bound(b, T: int, B: int, m: int, dtype, device):
    """Accepted bound shapes: scalar, ``(m,)``, ``(T, m)`` or ``(T, B, m)``.
    A 2-D bound is ALWAYS read as ``(T, m)``: a per-batch ``(B, m)`` bound
    is rejected rather than misread when ``T == B``."""
    if b is None:
        return None
    b = torch.as_tensor(b, dtype=dtype, device=device)
    if b.ndim == 0:
        return b.expand(T, B, m)
    if b.ndim == 1:
        # (1,) broadcasts unambiguously like a scalar for any n_ctrl
        if tuple(b.shape) not in ((m,), (1,)):
            raise ValueError(
                f"1-D control bound must be (n_ctrl={m},) or (1,); got {tuple(b.shape)}"
            )
        return b.expand(T, B, m)
    if b.ndim == 2:
        if tuple(b.shape) != (T, m):
            raise ValueError(
                f"2-D control bound is interpreted as (T={T}, n_ctrl={m}); "
                f"got {tuple(b.shape)}. For per-batch bounds pass the full "
                f"(T, B, m) array."
            )
        return b[:, None, :].expand(T, B, m)
    if b.ndim == 3:
        if b.shape[0] != T or b.shape[2] != m or b.shape[1] not in (1, B):
            raise ValueError(
                f"3-D control bound must broadcast to (T={T}, B={B}, "
                f"n_ctrl={m}); got {tuple(b.shape)}"
            )
        return b.expand(T, B, m)
    raise ValueError(f"control bound has too many dims: {tuple(b.shape)}")


def _expand_lin_dx(dx: LinDx, T: int, B: int, n: int, dtype, device) -> LinDx:
    """Accept F of ndim 2 ``(n, nm)``, 3 ``(T, n, nm)`` or 4
    ``(T, B, n, nm)``, and f of ndim 1/2/3 accordingly or None (zeros)."""
    F = torch.as_tensor(dx.F, dtype=dtype, device=device)
    if F.ndim == 2:
        F = F[None, None]
    elif F.ndim == 3:
        F = F[:, None]
    F = F.expand((T, B) + tuple(F.shape[-2:]))
    if dx.f is None:
        f = torch.zeros((T, B, n), dtype=dtype, device=device)
    else:
        f = torch.as_tensor(dx.f, dtype=dtype, device=device)
        if f.ndim == 1:
            f = f[None, None]
        elif f.ndim == 2:
            f = f[:, None]
        f = f.expand(T, B, n)
    return LinDx(F, f)


def _make_traj_cost_fn(cost_fn: Callable, mapped: Optional[Callable] = None) -> Callable:
    """Lift a per-sample scalar cost ``cost_fn(tau)`` to a trajectory cost
    ``(xs (T,...,n), us (T,...,m)) -> (...)``: mapped over every sample with
    ``torch.func.vmap`` (or by ``mapped``, ``flat (S, n+m) -> (S,)``, where
    given), summed over time."""

    def traj_cost(xs, us):
        tau = torch.cat([xs, us], -1)
        per = (vmap(cost_fn) if mapped is None else mapped)(tau.reshape(-1, tau.shape[-1]))
        return per.reshape(tau.shape[:-1]).sum(0)

    return traj_cost


def _augment_slew(config: MPCConfig, x_init, cost, dx, prev_ctrl):
    """The slew-rate penalty as a control-augmented problem: the state
    becomes ``[u_prev; x]`` (:class:`CtrlPassthroughDynamics`, or the
    augmented ``LinDx``), so that the cost sees consecutive controls; the
    penalty ``0.5 s ||u_t - u_{t-1}||^2`` lands in the quadratic blocks that
    couple the carried copy with the new control. ``prev_ctrl (B, m)``
    (zeros by default) starts the carried copy. A ``QuadCost`` (and a
    ``LinDx``) keeps its own leading shape, so a cost shared over the batch
    stays shared: ``mpc_solve`` expands it as a view. Returns the augmented
    ``(config, x_init, cost, dx)``."""
    n, m = config.n_state, config.n_ctrl
    s = config.slew_rate_penalty
    B, dtype, device = x_init.shape[0], x_init.dtype, x_init.device
    kw = dict(dtype=dtype, device=device)
    if isinstance(cost, QuadCost):
        C, c = _symmetric_cost(cost, dtype, device)
        N = n + 2 * m
        iu = torch.arange(m, device=device)  # the carried previous control
        ic = m + n + iu  # the current control
        slew = torch.zeros((N, N), **kw)
        slew[iu, iu] = s
        slew[ic, ic] = s
        slew[iu, ic] = -s
        slew[ic, iu] = -s
        cost_aug = QuadCost(pad(C, (m, 0, m, 0)) + slew, pad(c, (m, 0)))
    else:
        cost_aug = slew_cost(cost, n, m, s)
    if isinstance(dx, LinDx):
        F = torch.as_tensor(dx.F, **kw)
        lead = F.shape[:-2]
        top = torch.cat([torch.zeros((*lead, m, m + n), **kw), torch.eye(m, **kw).expand(*lead, m, m)], -1)
        f = None if dx.f is None else pad(torch.as_tensor(dx.f, **kw), (m, 0))
        dx_aug = LinDx(torch.cat([top, pad(F, (m, 0))], -2), f)
    else:
        dx_aug = CtrlPassthroughDynamics(inner=dx, n_ctrl=m)
    u0 = torch.zeros((B, m), **kw) if prev_ctrl is None else torch.as_tensor(prev_ctrl, **kw).reshape(B, m)
    x_init_aug = torch.cat([u0, x_init], -1)
    return dataclasses.replace(config, n_state=m + n, slew_rate_penalty=None), x_init_aug, cost_aug, dx_aug


def slew_cost(cost_fn: Callable, n: int, m: int, s: float) -> Callable:
    """A callable cost on the slew-augmented sample ``[u_prev; x; u]``: the
    cost of ``[x; u]`` and ``0.5 s ||u - u_prev||^2``."""

    def cost_aug(tau):
        return cost_fn(tau[m:]) + 0.5 * s * ((tau[m + n :] - tau[:m]) ** 2).sum()

    return cost_aug


def _zero_box(u_zero_I, u_lower, u_upper, T: int, B: int, m: int, dtype, device):
    """``u_zero_I`` as the degenerate box ``lo = hi = 0`` on its dims
    (broadcast to ``(T, B, m)``), the given bounds or ``-+1e18`` elsewhere:
    the box machinery (clamps, zeroed gain rows, the KKT backward's
    tight-dim freezing) then holds those dims at exactly zero."""
    mask = torch.as_tensor(u_zero_I, dtype=torch.bool, device=device).expand(T, B, m)
    big = torch.full((T, B, m), 1e18, dtype=dtype, device=device)
    lo = _expand_bound(u_lower, T, B, m, dtype, device)
    hi = _expand_bound(u_upper, T, B, m, dtype, device)
    zero = torch.zeros((), dtype=dtype, device=device)
    return (torch.where(mask, zero, -big if lo is None else lo),
            torch.where(mask, zero, big if hi is None else hi))


def _would_use_fused(config: MPCConfig, dx, *, is_quad: bool, constrained: bool, is_lin: bool) -> bool:
    """The fused-path predicate of the JAX package (``mpc.py:216-250``),
    without its TPU memory terms: QuadCost, box bounds, an entries-fusable
    env, no finite differences and no per-iteration printing."""
    return (
        is_quad
        and constrained
        and not is_lin
        and hasattr(dx, "entries_step")
        and hasattr(dx, "kernel_params")
        and getattr(dx, "kernel_fusable", True)
        and config.grad_method != GradMethods.FINITE_DIFF
        and config.verbose <= 0
    )


def _check_param_batch(dx, B: int) -> None:
    """Shape check for per-scenario dynamics params."""
    pbs = getattr(dx, "param_batch_shape", ())
    if pbs and pbs != (B,):
        raise ValueError(
            f"per-scenario dynamics params must have leading batch shape "
            f"({B},) to match x_init; got {pbs}. (If this model's shared "
            f"params is intentionally 2-D, override param_batch_shape to "
            f"return ().)"
        )


def _model_tensors(dx) -> list:
    """The tensors a gradient may reach in the dynamics."""
    if isinstance(dx, LinDx):
        return [dx.F, dx.f]
    if isinstance(dx, Dynamics):
        return dx.tensors()
    return [getattr(dx, "params", None)]


def _requires_grad(*xs) -> bool:
    return any(isinstance(x, torch.Tensor) and x.requires_grad for x in xs)


def _ilqr_loop(config: MPCConfig, x_init, C, c, dx, lo, hi, u_init, cost_fn=None, expansion=None,
               mapped_cost=None):
    """The non-fused iLQR loop (``mpc.py:467-631`` of the JAX package) on
    detached inputs: an initial rollout of ``u_init`` (or zeros, clamped into
    the box) through the true dynamics, then per iteration the linearization
    (and with a callable ``cost_fn``, the quadraticization that gives ``C,
    c``: ``expansion(xs, us)``, by default :func:`quadraticize_cost` of
    ``cost_fn``, the line search judging by ``mapped_cost``, by default
    ``vmap(cost_fn)``) and one :func:`lqr_step`, with the best trajectory, the
    not-improved counter and the per-scenario freeze kept as in the JAX
    ``Carry``. Scenarios that froze keep their state through ``where``. The
    loop stops at ``lqr_iter`` or when every scenario is done: one read of
    the ``done`` mask on the host per iteration. Returns ``(best_x, best_u,
    info)``.

    Under ``torch.export`` (``torch.compiler.is_exporting()``) the loop is
    ``torch``'s ``while_loop`` around one traced iteration, its condition the
    same two tests, so that an exported program holds the iteration once and
    runs it as the live loop does. The model's tensors are detached there
    instead of a no-grad region, which the program would keep as a
    submodule."""
    if torch.compiler.is_exporting():
        if isinstance(dx, Dynamics):
            name, statics, tensors = model_spec.encode(dx)
            dx = model_spec.decode(name, statics, [t.detach() for t in tensors])
        return _ilqr_iterations(config, x_init, C, c, dx, lo, hi, u_init, cost_fn, expansion, mapped_cost,
                                traced=True)
    with torch.no_grad():
        return _ilqr_iterations(config, x_init, C, c, dx, lo, hi, u_init, cost_fn, expansion, mapped_cost,
                                traced=False)


class _LoopInputs(NamedTuple):
    """What every iteration of the non-fused loop reads besides its carry."""

    x_init: torch.Tensor
    C: Optional[torch.Tensor]
    c: Optional[torch.Tensor]
    dx: object
    lo: Optional[torch.Tensor]
    hi: Optional[torch.Tensor]
    expansion: Optional[Callable]
    mapped_cost: Optional[Callable]


def _lift(inputs: _LoopInputs) -> tuple:
    """``inputs`` as a list of distinct tensors and the function that builds
    them back from another such list: a ``while_loop`` body may read no
    tensor of the program but its inputs. The model is taken apart by its
    codec; a traced expansion or mapped cost by its constants."""
    parts = [[inputs.x_init], [t for t in (inputs.C, inputs.c, inputs.lo, inputs.hi) if t is not None]]
    name, statics, model = model_spec.encode(inputs.dx)
    parts.append(model)
    parts += [[] if f is None else f.constants for f in (inputs.expansion, inputs.mapped_cost)]
    tensors, index = distinct_tensors(parts)
    present = [t is not None for t in (inputs.C, inputs.c, inputs.lo, inputs.hi)]

    def rebuild(lifted) -> _LoopInputs:
        x_init, quad, model, exp_k, mapped_k = ([lifted[i] for i in idx] for idx in index)
        quad = iter(quad)
        C, c, lo, hi = (next(quad) if p else None for p in present)
        return _LoopInputs(x_init[0], C, c, model_spec.decode(name, statics, model), lo, hi,
                           None if inputs.expansion is None else inputs.expansion.bind(exp_k),
                           None if inputs.mapped_cost is None else inputs.mapped_cost.bind(mapped_k))

    return tensors, rebuild


def _ilqr_iterations(config: MPCConfig, x_init, C, c, dx, lo, hi, u_init, cost_fn, expansion, mapped_cost,
                     traced: bool):
    """The body of :func:`_ilqr_loop`; ``traced`` runs its iterations by
    ``while_loop``, every tensor they read an input of the loop
    (:func:`_lift`)."""
    T, n, m = config.T, config.n_state, config.n_ctrl
    B, dtype, device = x_init.shape[0], x_init.dtype, x_init.device
    is_lin = isinstance(dx, LinDx)
    spec = LqrSpec(
        n_state=n, constrained=lo is not None, tight_eps=config.tight_eps,
        back_eps=config.back_eps, reg=config.back_eps, pnqp_iter=config.pnqp_iter,
        pnqp_enum=config.pnqp_enum, value_update_exact_reg=config.value_update_exact_reg,
        linesearch_decay=config.linesearch_decay,
        max_linesearch_iter=config.max_linesearch_iter, delta_u=config.delta_u,
        use_cuda=config.use_cuda,
    )
    u = torch.zeros((T, B, m), dtype=dtype, device=device) if u_init is None else u_init
    if lo is not None:
        u = torch.minimum(torch.maximum(u, lo), hi)
    x = rollout(dx, x_init, u)
    best_x, best_u = (x.clone(), u.clone()) if traced else (x, u)  # a loop's inputs may not alias
    if cost_fn is not None and expansion is None:
        expansion = functools.partial(quadraticize_cost, cost_fn)
    best_obj = trajectory_cost(C, c, x, u) if cost_fn is None else _make_traj_cost_fn(cost_fn, mapped_cost)(x, u)
    n_not_improved = torch.zeros(B, dtype=torch.int32, device=device)
    last_improvement = torch.full((B,), float("inf"), dtype=dtype, device=device)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    alpha = torch.ones(B, dtype=dtype, device=device)
    clamp_frac = torch.zeros(B, dtype=dtype, device=device)
    qp_iters = torch.zeros(B, dtype=dtype, device=device)

    def iteration(inputs: _LoopInputs, i, x, u, best_x, best_u, best_obj, n_not_improved, last_improvement, done,
                  alpha, clamp_frac, qp_iters):
        x_init, C, c, dx, lo, hi, expansion, mapped_cost = inputs
        traj_cost = None if cost_fn is None else _make_traj_cost_fn(cost_fn, mapped_cost)
        F, f = linearize(dx, x, u, config.grad_method)
        if cost_fn is not None:
            C, c = expansion(x, u)
        out = lqr_step(spec, x_init, C, c, F, f, x, u, lo, hi, dyn=None if is_lin else dx, cost_fn=traj_cost)
        improvement = best_obj - out.objs
        # best tracks any strict improvement; best_cost_eps only drives the
        # not-improved counter
        improved = out.objs < best_obj
        improved_sig = out.objs < best_obj - config.best_cost_eps
        best_obj = torch.where(improved, out.objs, best_obj)
        best_x = torch.where(improved[None, :, None], out.xs, best_x)
        best_u = torch.where(improved[None, :, None], out.us, best_u)
        n_not_improved = torch.where(improved_sig, 0, n_not_improved + 1)
        newly_done = (improvement < config.eps) | (n_not_improved >= config.not_improved_lim)
        # frozen scenarios keep their state; active ones move to the new
        # trajectory even if it is worse (best_* keeps the winner)
        act = ~done
        x = torch.where(act[None, :, None], out.xs, x)
        u = torch.where(act[None, :, None], out.us, u)
        if config.verbose > 0:
            print(
                f"ilqr iter {i}: mean obj {float(best_obj.mean()):.6f} "
                f"mean alpha {float(out.alpha.mean()):.3f}"
            )
        last_improvement = torch.where(act, improvement, last_improvement)
        done = done | newly_done
        alpha = torch.where(act, out.alpha, alpha)
        free_share = out.free_mask.to(dtype).mean(dim=(0, 2))
        clamp_frac = torch.where(act, torch.clamp(1.0 - free_share, 0.0, 1.0), clamp_frac)
        qp_iters = torch.where(act, out.n_qp_iter.to(dtype).mean(dim=0), qp_iters)
        return x, u, best_x, best_u, best_obj, n_not_improved, last_improvement, done, alpha, clamp_frac, qp_iters

    inputs = _LoopInputs(x_init, C, c, dx, lo, hi, expansion, mapped_cost)
    carry = (x, u, best_x, best_u, best_obj, n_not_improved, last_improvement, done, alpha, clamp_frac, qp_iters)
    k = len(carry)  # the loop's arguments: the iteration count, the carry, then the lifted inputs
    if traced:
        # the live loop's exit, and one traced iteration on the lifted inputs
        lifted, rebuild = _lift(inputs)
        n_iters, *carry = while_loop_op(
            lambda i, *args: (i < config.lqr_iter) & ~args[7].all(),
            lambda i, *args: (i + 1, *iteration(rebuild(args[k:]), None, *args[:k])),
            (torch.zeros((), dtype=torch.int32, device=device), *carry), tuple(lifted))
    else:
        i = 0
        while i < config.lqr_iter and not bool(carry[7].all()):
            carry = iteration(inputs, i, *carry)
            i += 1
        n_iters = torch.tensor(i, dtype=torch.int32, device=device)
    _, _, best_x, best_u, _, _, last_improvement, _, alpha, clamp_frac, qp_iters = carry
    info = MPCInfo(
        converged=last_improvement < config.eps,
        n_iters=n_iters,
        last_improvement=last_improvement,
        mean_alpha=alpha,
        clamp_frac=clamp_frac,
        qp_iters=qp_iters,
    )
    return best_x, best_u, info


def mpc_solve(
    config: MPCConfig,
    x_init: torch.Tensor,
    cost: CostLike,
    dx,
    u_init: Optional[torch.Tensor] = None,
    u_lower=None,
    u_upper=None,
    prev_ctrl: Optional[torch.Tensor] = None,
    u_zero_I=None,
) -> MPCSolution:
    """Solve a batch of (possibly nonlinear, box-constrained) MPC problems.

    Same contract as :func:`diffmpc_tpu.mpc.mpc_solve`; the solve follows
    ``x_init``'s dtype and device. ``cost`` is a ``QuadCost`` or a callable
    ``cost(tau) -> scalar`` on one ``(n+m,)`` sample (written in torch ops
    that ``torch.func`` can map and differentiate); ``dx`` is an env or a
    ``LinDx``; bounds may be None for an unconstrained problem.
    ``prev_ctrl (B, m)`` anchors the slew-rate penalty's first step (zeros
    by default); ``u_zero_I`` (broadcast to ``(T, B, m)``) holds its dims at
    exactly zero.
    """
    return _mpc_solve(config, x_init, cost, dx, u_init, u_lower, u_upper, prev_ctrl, u_zero_I)


def _mpc_solve(config: MPCConfig, x_init, cost, dx, u_init=None, u_lower=None, u_upper=None, prev_ctrl=None,
               u_zero_I=None, attach: Optional[bool] = None, expansion: Optional[Callable] = None,
               mapped_cost: Optional[Callable] = None) -> MPCSolution:
    """:func:`mpc_solve`, with ``attach`` saying whether the solved
    trajectory is attached to the inputs for the gradient (None: where a
    gradient may be taken, as :func:`mpc_solve` decides), and, for a
    callable cost, ``expansion(xs, us) -> (C, c)`` its quadraticization in
    the loop and the attach (None: :func:`quadraticize_cost`) and
    ``mapped_cost(flat (S, n+m)) -> (S,)`` the cost of each sample for the
    line search and the objective (None: ``vmap`` of the cost), each of the
    slew-augmented cost under the slew penalty. An exported program
    (:mod:`diffmpc_tpu_torch.aot`) sets ``attach`` from its ``vjp_order``
    and passes its traces of both."""
    if config.slew_rate_penalty is not None and config.slew_rate_penalty > 0:
        # checked here: the augmented model wraps dx and hides its params
        _check_param_batch(dx, x_init.shape[0] if x_init.ndim else 0)
        config_aug, x_init_aug, cost_aug, dx_aug = _augment_slew(config, x_init, cost, dx, prev_ctrl)
        # the control space is unchanged, so the control-shaped knobs apply as they are
        sol = _mpc_solve(config_aug, x_init_aug, cost_aug, dx_aug, u_init, u_lower, u_upper, u_zero_I=u_zero_I,
                         attach=attach, expansion=expansion, mapped_cost=mapped_cost)
        return MPCSolution(sol.xs[..., config.n_ctrl :], sol.us, sol.objs, sol.info)
    T, n, m = config.T, config.n_state, config.n_ctrl
    if x_init.ndim != 2 or x_init.shape[-1] != n:
        raise ValueError(f"x_init must be (B, n_state={n}); got {tuple(x_init.shape)}")
    B = x_init.shape[0]
    dtype, device = x_init.dtype, x_init.device
    is_quad = isinstance(cost, QuadCost)
    is_lin = isinstance(dx, LinDx)
    if is_quad and cost.C.shape[-1] != n + m:
        raise ValueError(
            f"QuadCost.C trailing dim must be n_state+n_ctrl={n + m}; "
            f"got {tuple(cost.C.shape)}"
        )
    if is_lin and tuple(dx.F.shape[-2:]) != (n, n + m):
        raise ValueError(
            f"LinDx.F trailing dims must be (n_state={n}, n_state+n_ctrl={n + m}); "
            f"got {tuple(dx.F.shape)}"
        )
    if (u_lower is None) != (u_upper is None):
        raise ValueError("u_lower and u_upper must be both set or both None")
    _check_param_batch(dx, B)
    if u_zero_I is not None:
        lo, hi = _zero_box(u_zero_I, u_lower, u_upper, T, B, m, dtype, device)
    else:
        lo = _expand_bound(u_lower, T, B, m, dtype, device)
        hi = _expand_bound(u_upper, T, B, m, dtype, device)
    constrained = lo is not None

    if attach is None:
        attach = (
            config.backprop
            and torch.is_grad_enabled()
            and (not is_quad or _requires_grad(x_init, cost.C, cost.c, *_model_tensors(dx)))
        )

    if is_quad:
        cost = _expand_cost(cost, T, B, dtype, device)
    if is_lin:
        dx = _expand_lin_dx(dx, T, B, n, dtype, device)
    u0 = None
    if u_init is not None:
        u0 = torch.as_tensor(u_init, dtype=dtype, device=device).detach()
        if u0.ndim == 2:
            u0 = u0[:, None].expand(T, B, m)

    if _would_use_fused(config, dx, is_quad=is_quad, constrained=constrained, is_lin=is_lin):
        fr = ilqr_solve_fused(
            x_init.detach(),
            cost.C.detach(),
            cost.c.detach(),
            dx,
            lo.detach(),
            hi.detach(),
            u_init=u0,
            lqr_iter=config.lqr_iter,
            pnqp_iter=min(config.pnqp_iter, 8),
            pnqp_enum=config.pnqp_enum,
            value_update_exact_reg=config.value_update_exact_reg,
            reg=config.back_eps,
            decay=config.linesearch_decay,
            max_linesearch_iter=config.max_linesearch_iter,
            delta_u=config.delta_u,
            eps=config.eps,
            best_cost_eps=config.best_cost_eps,
            not_improved_lim=config.not_improved_lim,
            hoist_lin=config.hoist_lin,
            use_cuda=config.use_cuda,
        )
        best_x, best_u = fr.xs, fr.us
        tol = config.tight_eps
        at_bound = (best_u <= lo + tol) | (best_u >= hi - tol)
        info = MPCInfo(
            converged=fr.converged,
            # iterations until ALL scenarios froze: the max of the per-scenario counts
            n_iters=fr.n_iters.max(),
            last_improvement=fr.last_improvement,
            mean_alpha=fr.alpha,
            clamp_frac=torch.clamp(at_bound.to(dtype).mean(dim=(0, 2)), 0.0, 1.0),
            qp_iters=fr.qp_iters,
        )
    else:
        dx_sg = LinDx(dx.F.detach(), dx.f.detach()) if is_lin else dx
        C_sg, c_sg = (cost.C.detach(), cost.c.detach()) if is_quad else (None, None)
        best_x, best_u, info = _ilqr_loop(
            config, x_init.detach(), C_sg, c_sg, dx_sg,
            None if lo is None else lo.detach(), None if hi is None else hi.detach(), u0,
            cost_fn=None if is_quad else cost, expansion=expansion, mapped_cost=mapped_cost,
        )

    xs, us = best_x, best_u
    if attach:
        # the differentiable fixed-point attach (mpc.py:639-671 of the JAX
        # package): the LinDx arrays themselves, or the model linearized once
        # more at the solved trajectory with gradients flowing from its
        # tensors, and the cost (quadraticized there if it is callable);
        # then the custom backward
        F, f = linearize(dx, xs, us, config.grad_method)
        if is_quad:
            C, c = cost.C, cost.c
        else:
            C, c = quadraticize_cost(cost, best_x, best_u) if expansion is None else expansion(best_x, best_u)
        big = torch.full((T, B, m), 1e18, dtype=dtype, device=device)
        spec = LqrSpec(
            n_state=n, constrained=constrained, tight_eps=config.tight_eps,
            back_eps=config.back_eps, value_update_exact_reg=config.value_update_exact_reg,
            use_cuda=config.use_cuda,
        )
        xs, us = lqr_fixed_point(
            spec, x_init, C, c, F, f, best_x, best_u,
            lo if constrained else -big, hi if constrained else big,
        )
        if config.detach_unconverged:
            keep = info.converged[None, :, None]
            xs = torch.where(keep, xs, best_x)
            us = torch.where(keep, us, best_u)
    objs = trajectory_cost(cost.C, cost.c, xs, us) if is_quad else _make_traj_cost_fn(cost, mapped_cost)(xs, us)
    return MPCSolution(xs, us, objs, info)


class MPC:
    """Eager wrapper with the reference's ``MPC`` module API:
    ``MPC(n_state, n_ctrl, T, ...)(x_init, cost, dx) -> (x, u, objs)``."""

    def __init__(
        self,
        n_state: int,
        n_ctrl: int,
        T: int,
        u_lower=None,
        u_upper=None,
        u_init=None,
        lqr_iter: int = 10,
        grad_method: GradMethods = GradMethods.ANALYTIC,
        delta_u: Optional[float] = None,
        verbose: int = 0,
        eps: float = 1e-7,
        back_eps: float = 1e-7,
        n_batch: Optional[int] = None,
        linesearch_decay: float = 0.2,
        max_linesearch_iter: int = 10,
        exit_unconverged: bool = True,
        detach_unconverged: bool = True,
        backprop: bool = True,
        slew_rate_penalty: Optional[float] = None,
        prev_ctrl=None,
        not_improved_lim: int = 5,
        best_cost_eps: float = 1e-4,
        pnqp_iter: int = 20,
        u_zero_I=None,
        use_cuda: Optional[bool] = None,
        pnqp_enum: str = "",
        value_update_exact_reg: float = -1.0,
    ):
        self.config = MPCConfig(
            n_state=n_state,
            n_ctrl=n_ctrl,
            T=T,
            lqr_iter=lqr_iter,
            grad_method=grad_method,
            delta_u=delta_u,
            verbose=verbose,
            eps=eps,
            back_eps=back_eps,
            linesearch_decay=linesearch_decay,
            max_linesearch_iter=max_linesearch_iter,
            exit_unconverged=exit_unconverged,
            detach_unconverged=detach_unconverged,
            backprop=backprop,
            not_improved_lim=not_improved_lim,
            best_cost_eps=best_cost_eps,
            slew_rate_penalty=slew_rate_penalty,
            pnqp_iter=pnqp_iter,
            use_cuda=use_cuda,
            pnqp_enum=pnqp_enum,
            value_update_exact_reg=value_update_exact_reg,
        )
        self.u_lower = u_lower
        self.u_upper = u_upper
        self.u_init = u_init
        self.prev_ctrl = prev_ctrl
        self.n_batch = n_batch
        self.u_zero_I = u_zero_I

    def solve(self, x_init, cost, dx) -> MPCSolution:
        if self.config.grad_method == GradMethods.ANALYTIC_CHECK and not isinstance(dx, LinDx):
            # the model's Jacobians against autodiff at the start, held for
            # the horizon with zero controls (diffmpc_tpu/mpc.py:752-760);
            # a LinDx has nothing to check
            T, B = self.config.T, x_init.shape[0]
            u_probe = torch.zeros((T, B, self.config.n_ctrl), dtype=x_init.dtype, device=x_init.device)
            check_analytic_grads(dx, x_init.detach().expand(T, *x_init.shape), u_probe)
        sol = mpc_solve(
            self.config,
            x_init,
            cost,
            dx,
            u_init=self.u_init,
            u_lower=self.u_lower,
            u_upper=self.u_upper,
            prev_ctrl=self.prev_ctrl,
            u_zero_I=self.u_zero_I,
        )
        if self.config.exit_unconverged and not bool(sol.info.converged.all()):
            n_bad = int((~sol.info.converged).sum())
            raise RuntimeError(
                f"MPC did not converge for {n_bad} batch element(s) "
                f"(exit_unconverged=True; pass exit_unconverged=False to "
                f"keep best trajectories instead)"
            )
        return sol

    def __call__(self, x_init, cost, dx):
        sol = self.solve(x_init, cost, dx)
        return sol.xs, sol.us, sol.objs
