"""Dynamics linearization and cost quadraticization (counterpart of
:mod:`diffmpc_tpu.ops.linearize`).

The fused solve linearizes inside its kernel and needs nothing from here.
:func:`linearize_dynamics` serves the non-fused iLQR loop (once per
iteration) and the differentiable fixed-point attach of ``mpc_solve``: it
linearizes the env about a trajectory in ordinary PyTorch ops, so that
autograd carries the KKT backward's ``dF, df`` on to the env's parameters.
:func:`quadraticize_cost` does the same for a callable cost, whose tensors
then receive ``dC, dc``; :func:`trace_quadraticize` is the same expansion
traced once at a fixed sample count (and :func:`trace_mapped_cost` the cost
mapped over a fixed number of samples), for an exported program
(:mod:`diffmpc_tpu_torch.aot`).
:func:`check_analytic_grads` is ``GradMethods.ANALYTIC_CHECK``'s check,
which ``MPC.solve`` runs.
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
    return _absolute_form(_derivatives(cost_fn), xs, us)


def _derivatives(cost_fn: Callable) -> Callable:
    """``flat (S, nm) -> (g (S, nm), H (S, nm, nm))``, the cost's gradient
    and Hessian at each sample."""

    def derivatives(flat):
        return vmap(grad(cost_fn))(flat), vmap(hessian(cost_fn))(flat)

    return derivatives


def _absolute_form(derivatives: Callable, xs: torch.Tensor, us: torch.Tensor):
    tau = torch.cat([xs, us], -1)
    T, B, nm = tau.shape
    g, H = derivatives(tau.reshape(-1, nm))
    g, H = g.reshape(T, B, nm), H.reshape(T, B, nm, nm)
    return H, g - bmv(H, tau)


def _lift_constants(gm: torch.fx.GraphModule) -> list:
    """Make each tensor that ``gm``'s graph reads as an attribute (a
    ``get_attr`` node: a tensor the traced function closed over, or one made
    while tracing) a trailing input of ``gm``, in place, after removing dead
    code; returns those tensors in input order, each once."""
    graph = gm.graph
    graph.eliminate_dead_code()
    last = [node for node in graph.nodes if node.op == "placeholder"][-1]
    constants, inputs, targets = [], {}, set()
    for node in list(graph.nodes):
        if node.op != "get_attr":
            continue
        t = getattr(gm, node.target)
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"the trace reads a {type(t).__name__} attribute {node.target!r}, not a tensor")
        if id(t) not in inputs:
            with graph.inserting_after(last):
                last = inputs[id(t)] = graph.placeholder(f"constant_{len(constants)}")
            constants.append(t)
        node.replace_all_uses_with(inputs[id(t)])
        graph.erase_node(node)
        targets.add(node.target)
    for target in targets:
        delattr(gm, target)
    gm.recompile()
    return constants


def distinct_tensors(parts: list) -> tuple:
    """The tensors of ``parts`` (lists of tensors), each once by identity,
    and for each part the positions of its tensors in that list."""
    tensors = []
    for t in (t for part in parts for t in part):
        if not any(t is u for u in tensors):
            tensors.append(t)
    return tensors, [[next(i for i, u in enumerate(tensors) if t is u) for t in part] for part in parts]


class TracedFn:
    """A function traced once by ``make_fx`` on example inputs, its tensor
    constants made trailing inputs of the graph: a call runs ``graph`` on its
    arguments and ``constants``, and :meth:`bind` gives the same graph on
    other tensors of the same shapes (an exported program's inputs, so that
    the program holds no state)."""

    def __init__(self, graph: torch.fx.GraphModule, constants: list):
        self.graph, self.constants = graph, list(constants)

    def __call__(self, *args):
        return self.graph(*args, *self.constants)

    def bind(self, constants: list) -> "TracedFn":
        return type(self)(self.graph, constants)


class TracedQuadraticization(TracedFn):
    """:func:`quadraticize_cost` of one cost with its derivatives traced:
    ``(xs, us) -> (C, c)`` at the traced sample count ``T * B``."""

    def __call__(self, xs: torch.Tensor, us: torch.Tensor):
        return _absolute_form(super().__call__, xs, us)


def _trace(fn: Callable, example: torch.Tensor, name: str) -> tuple:
    from torch.fx.experimental.proxy_tensor import make_fx

    try:
        gm = make_fx(fn)(example)
        return gm, _lift_constants(gm)
    except Exception as e:
        raise RuntimeError(f"the callable cost {name} could not be traced: {e}") from e


class TracedMappedCost:
    """The per-sample cost mapped over samples, ``flat (S, nm) -> (S,)``, with
    ``vmap(cost_fn)``'s operations traced once by ``make_fx`` at each sample
    count ``S`` a program evaluates it at, so that the program runs no
    ``vmap`` (which does not serialize). ``constants`` and :meth:`bind` are
    :class:`TracedFn`'s, over the traces in order."""

    def __init__(self, traces: dict):
        self.traces = traces
        self.constants = [t for traced in traces.values() for t in traced.constants]

    def __call__(self, flat: torch.Tensor) -> torch.Tensor:
        if flat.shape[0] not in self.traces:
            raise ValueError(f"the cost is traced at {sorted(self.traces)} samples, not {flat.shape[0]}")
        return self.traces[flat.shape[0]](flat)

    def bind(self, constants: list) -> "TracedMappedCost":
        out, at = {}, 0
        for samples, traced in self.traces.items():
            out[samples] = traced.bind(constants[at:at + len(traced.constants)])
            at += len(traced.constants)
        return TracedMappedCost(out)


def trace_mapped_cost(cost_fn: Callable, sample_counts, nm: int, dtype, device) -> TracedMappedCost:
    """``vmap(cost_fn)`` traced at each of ``sample_counts`` samples of
    ``nm``; the cost's closed-over tensors are the traces' constants."""
    return TracedMappedCost({S: TracedFn(*_trace(vmap(cost_fn), torch.zeros((S, nm), dtype=dtype, device=device),
                                                 _name(cost_fn))) for S in sample_counts})


def trace_quadraticize(cost_fn: Callable, samples: int, nm: int, dtype, device) -> TracedQuadraticization:
    """:func:`quadraticize_cost` of ``cost_fn`` about ``samples = T * B``
    samples, its ``vmap(grad)`` and ``vmap(hessian)`` traced once by
    ``make_fx`` at ``(samples, nm)``: ``torch.func``'s transforms do not
    trace under ``torch.export``, and the graph is their operations, run on
    any trajectory of that shape. It computes what :func:`quadraticize_cost`
    computes, operation for operation (less the dead ones, which would only
    run); the tensors the trace reads (the cost's closed-over tensors, or
    made while tracing) are :attr:`~TracedFn.constants`. A cost that cannot
    be traced raises, naming it."""
    example = torch.zeros((samples, nm), dtype=dtype, device=device)
    return TracedQuadraticization(*_trace(_derivatives(cost_fn), example, _name(cost_fn)))


def _name(fn) -> str:
    return getattr(fn, "__qualname__", None) or type(fn).__name__
