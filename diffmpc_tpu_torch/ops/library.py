"""The solve path's kernels as ``torch.library`` operators, namespace ``diffmpc``.

The kernels are launched through ctypes on raw pointers, which
``torch.export`` cannot trace, and ``torch.func`` does not trace under
export either. So each entry point of the solve path is an op with a fake
(shape) implementation: an exported program (:mod:`diffmpc_tpu_torch.aot`)
records one node per call, and running it calls the op again. The live path
(:mod:`diffmpc_tpu_torch.mpc`, :mod:`~diffmpc_tpu_torch.ops.lqr_step`) goes
through the same ops, so the two share one route. Each op's body is the
existing entry point, registered for CPU and CUDA tensors: on CUDA tensors
it launches the hand-written kernel through its launcher (or raises), which
adds one to that kernel's launch count; on CPU tensors it runs the plain
version.

- ``diffmpc::ilqr_solve_fused``: the fused solve
  (:func:`~diffmpc_tpu_torch.ops.cuda.ilqr.ilqr_solve_fused`);
- ``diffmpc::riccati_backward`` and ``diffmpc::linesearch_rollout``: the
  non-fused step's sweep and line search (:mod:`~diffmpc_tpu_torch.ops.lqr`;
  each streaming twin behind its dispatch, :mod:`~.cuda.horizon`);
- ``diffmpc::kkt_backward``: the analytic KKT backward
  (:func:`~diffmpc_tpu_torch.ops.cuda.kkt.kkt_backward_fused`);
- ``diffmpc::lqr_fixed_point``: the identity on a solved trajectory, whose
  registered backward is the ``kkt_backward`` op;
- ``diffmpc::linearize``: the model's affine expansion
  (:func:`~diffmpc_tpu_torch.ops.linearize.linearize_dynamics`), whose body
  may use ``torch.func`` (the Jacobians without a closed form); its
  autograd kernel computes the expansion in autograd where a gradient may be
  taken, so its backward is autograd's own, inside the op.

A model enters an op as ``(class name, statics, tensors)``
(:mod:`diffmpc_tpu_torch.models.spec`). Ops take and return tensors only:
the wrappers below keep the entry points' signatures and result types.

The ops are defined with ``torch.library.Library`` (a schema, a kernel for
CPU and for CUDA tensors, a fake implementation, an autograd kernel where
there is a gradient), not ``torch.library.custom_op``, whose Python wrapper
costs ~5x the dispatch on every call (its checks walk every argument): the
steps that call them are host-bound. The kernels return no output that
shares storage with an input or another output (:func:`_fresh`), the
contract of an operator that export relies on.
"""

from __future__ import annotations

import weakref
from typing import Optional

import torch
from torch import Tensor
from torch.autograd.function import once_differentiable

from ..models import spec
from ..types import GradMethods, LinDx
from ..utils.batch import bmv
from .cuda.ilqr import FusedSolveResult
from .cuda.ilqr import ilqr_solve_fused as _ilqr_solve_fused
from .cuda.kkt import kkt_backward_fused
from .cuda.riccati import RiccatiResult
from .cuda.rollout import LineSearchResult
from .linearize import linearize_dynamics
from .lqr import lqr_linesearch_rollout, riccati_backward as _riccati_backward

NAMESPACE = "diffmpc"


def _fresh(outs, inputs=()) -> tuple:
    """The outputs, each copied where it is an input or a view of one, or
    shares storage with an earlier output: an op's returns may alias neither
    (the line search's statistics come back as rows of one buffer)."""
    given = {id(t) for t in inputs} | {id(t._base) for t in inputs if t._base is not None}
    seen, out = set(), []
    for t in outs:
        ptr = t.untyped_storage().data_ptr()
        if id(t) in given or (t._base is not None and id(t._base) in given) or ptr in seen:
            t = t.clone()
            ptr = t.untyped_storage().data_ptr()
        seen.add(ptr)
        out.append(t)
    return tuple(out)


def _tensors(*args) -> tuple:
    return tuple(a for a in args if a is not None)


_LIB = torch.library.Library(NAMESPACE, "FRAGMENT")


def _define(schema: str, kernel, fake, autograd=None):
    """Define the op of ``schema`` in :data:`NAMESPACE` with ``kernel`` for CPU
    and CUDA tensors, ``fake`` for export's shapes and, where given,
    ``autograd`` as its autograd kernel; returns its overload."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    for key in ("CPU", "CUDA"):
        _LIB.impl(name, kernel, key)
    if autograd is not None:
        _LIB.impl(name, autograd, "Autograd")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


# each model's (name, statics, tensors, detached tensors), kept while the model
# lives: a solve's fused call and its attach encode one model, and a receding
# loop passes one model at every step. A model is frozen: its fields cannot
# be reassigned.
_ENCODED = weakref.WeakKeyDictionary()


def _encoded(dyn) -> tuple:
    got = _ENCODED.get(dyn)
    if got is None:
        name, statics, tensors = spec.encode(dyn)
        got = _ENCODED[dyn] = (name, statics, tensors, [t.detach() for t in tensors])
    return got


def _model(dyn):
    """``(name, statics, detached tensors)`` of ``dyn`` for an op that
    computes no gradient, or ``("", "", [])`` for None."""
    if dyn is None:
        return "", "", []
    name, statics, _, detached = _encoded(dyn)
    return name, statics, detached


def _opt(x, cast):
    return None if x is None else cast(x)


# ---------------------------------------------------------------------------
# The fused solve.
# ---------------------------------------------------------------------------


def _ilqr_kernel(x_init, C, c, model, statics, tensors, u_lower, u_upper, u_init, lqr_iter, pnqp_iter, pnqp_enum,
                 value_update_exact_reg, reg, decay, max_linesearch_iter, delta_u, eps, best_cost_eps,
                 not_improved_lim, hoist_lin, unroll, use_cuda):
    return _fresh(_ilqr_solve_fused(
        x_init, C, c, spec.decode(model, statics, tensors), u_lower, u_upper, u_init=u_init, lqr_iter=lqr_iter,
        pnqp_iter=pnqp_iter, pnqp_enum=pnqp_enum, value_update_exact_reg=value_update_exact_reg, reg=reg,
        decay=decay, max_linesearch_iter=max_linesearch_iter, delta_u=delta_u, eps=eps, best_cost_eps=best_cost_eps,
        not_improved_lim=not_improved_lim, hoist_lin=hoist_lin, unroll=unroll, use_cuda=use_cuda,
    ), _tensors(x_init, C, c, *tensors, u_lower, u_upper, u_init))


def _ilqr_fake(x_init, C, c, model, statics, tensors, u_lower, u_upper, u_init, *knobs):
    B, n = x_init.shape
    T, m = C.shape[0], C.shape[-1] - n
    new = x_init.new_empty
    return (new((T, B, n)), new((T, B, m)), new((B,)), new((B,), dtype=torch.bool), new((B,)), new((B,)),
            new((B,), dtype=torch.int32), new((B,)))


ilqr_solve_fused_op = _define(
    "ilqr_solve_fused(Tensor x_init, Tensor C, Tensor c, str model, str statics, Tensor[] tensors, Tensor u_lower, "
    "Tensor u_upper, Tensor? u_init, int lqr_iter, int pnqp_iter, str pnqp_enum, float value_update_exact_reg, "
    "float reg, float decay, int max_linesearch_iter, float? delta_u, float eps, float best_cost_eps, "
    "int not_improved_lim, bool hoist_lin, bool unroll, bool? use_cuda) "
    "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
    _ilqr_kernel, _ilqr_fake,
)


def ilqr_solve_fused(
    x_init: Tensor, C: Tensor, c: Tensor, dyn, u_lower: Tensor, u_upper: Tensor, *,
    u_init: Optional[Tensor] = None, lqr_iter: int = 10, pnqp_iter: int = 8, pnqp_enum: str = "",
    value_update_exact_reg: float = -1.0, reg: float = 1e-9, decay: float = 0.2, max_linesearch_iter: int = 10,
    delta_u: Optional[float] = None, eps: float = 1e-7, best_cost_eps: float = 1e-4, not_improved_lim: int = 5,
    hoist_lin: bool = False, unroll: bool = False, use_cuda: Optional[bool] = None,
) -> FusedSolveResult:
    """:func:`~diffmpc_tpu_torch.ops.cuda.ilqr.ilqr_solve_fused` through the
    ``diffmpc::ilqr_solve_fused`` op: the same arguments and result."""
    return FusedSolveResult(*ilqr_solve_fused_op(
        x_init, C, c, *_model(dyn), u_lower, u_upper, u_init, int(lqr_iter), int(pnqp_iter), pnqp_enum,
        float(value_update_exact_reg), float(reg), float(decay), int(max_linesearch_iter), _opt(delta_u, float),
        float(eps), float(best_cost_eps), int(not_improved_lim), bool(hoist_lin), bool(unroll), use_cuda,
    ))


# ---------------------------------------------------------------------------
# The non-fused step: the Riccati sweep and the line search.
# ---------------------------------------------------------------------------


def _riccati_kernel(C, c, F, f, n_state, u_lower, u_upper, u_hat, ctrl_mask, reg, pnqp_iter, pnqp_enum,
                    value_update_exact_reg, use_cuda):
    return _fresh(_riccati_backward(
        C, c, F, f, n_state, u_lower=u_lower, u_upper=u_upper, u_hat=u_hat, ctrl_mask=ctrl_mask, reg=reg,
        pnqp_iter=pnqp_iter, pnqp_enum=pnqp_enum, value_update_exact_reg=value_update_exact_reg, use_cuda=use_cuda,
    ), _tensors(C, c, F, f, u_lower, u_upper, u_hat, ctrl_mask))


def _riccati_fake(C, c, F, f, n_state, *rest):
    T, B, nm = c.shape
    n, m = n_state, nm - n_state
    new = C.new_empty
    return new((T, B, m, n)), new((T, B, m)), new((T, B, m), dtype=torch.bool), new((T, B), dtype=torch.int32)


riccati_backward_op = _define(
    "riccati_backward(Tensor C, Tensor c, Tensor F, Tensor? f, int n_state, Tensor? u_lower, Tensor? u_upper, "
    "Tensor? u_hat, Tensor? ctrl_mask, float reg, int pnqp_iter, str pnqp_enum, float value_update_exact_reg, "
    "bool? use_cuda) -> (Tensor, Tensor, Tensor, Tensor)",
    _riccati_kernel, _riccati_fake,
)


def riccati_backward(
    C: Tensor, c: Tensor, F: Tensor, f: Optional[Tensor], n_state: int, *, u_lower: Optional[Tensor] = None,
    u_upper: Optional[Tensor] = None, u_hat: Optional[Tensor] = None, ctrl_mask: Optional[Tensor] = None,
    reg: float = 1e-9, pnqp_iter: int = 20, pnqp_enum: str = "", value_update_exact_reg: float = -1.0,
    use_cuda: Optional[bool] = None,
) -> RiccatiResult:
    """:func:`~diffmpc_tpu_torch.ops.lqr.riccati_backward` through the
    ``diffmpc::riccati_backward`` op: the same arguments and result."""
    return RiccatiResult(*riccati_backward_op(
        C, c, F, f, int(n_state), u_lower, u_upper, u_hat, ctrl_mask, float(reg), int(pnqp_iter), pnqp_enum,
        float(value_update_exact_reg), use_cuda,
    ))


def _linesearch_kernel(x_init, C, c, F, f, K, k, x_hat, u_hat, u_lower, u_upper, delta_u, model, statics, tensors,
                       decay, max_iter, use_cuda):
    return _fresh(lqr_linesearch_rollout(
        x_init, C, c, F, f, K, k, x_hat, u_hat, u_lower=u_lower, u_upper=u_upper, delta_u=delta_u,
        dyn=spec.decode(model, statics, tensors) if model else None, decay=decay, max_iter=max_iter,
        use_cuda=use_cuda,
    ), _tensors(x_init, C, c, F, f, K, k, x_hat, u_hat, u_lower, u_upper, *tensors))


def _linesearch_fake(x_init, C, c, F, f, K, k, x_hat, u_hat, *rest):
    T, B, m, n = K.shape
    new = x_init.new_empty
    return new((T, B, n)), new((T, B, m)), new((B,)), new((B,)), new((B,), dtype=torch.bool)


linesearch_rollout_op = _define(
    "linesearch_rollout(Tensor x_init, Tensor C, Tensor c, Tensor? F, Tensor? f, Tensor K, Tensor k, Tensor x_hat, "
    "Tensor u_hat, Tensor? u_lower, Tensor? u_upper, float? delta_u, str model, str statics, Tensor[] tensors, "
    "float decay, int max_iter, bool? use_cuda) -> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    _linesearch_kernel, _linesearch_fake,
)


def linesearch_rollout(
    x_init: Tensor, C: Tensor, c: Tensor, F: Optional[Tensor], f: Optional[Tensor], K: Tensor, k: Tensor,
    x_hat: Tensor, u_hat: Tensor, *, u_lower: Optional[Tensor] = None, u_upper: Optional[Tensor] = None,
    delta_u: Optional[float] = None, dyn=None, decay: float = 0.2, max_iter: int = 10,
    use_cuda: Optional[bool] = None,
) -> LineSearchResult:
    """The kernel route of :func:`~diffmpc_tpu_torch.ops.lqr.lqr_linesearch_rollout`
    (linear dynamics, or ``dyn``'s kernel step, under the quadratic cost)
    through the ``diffmpc::linesearch_rollout`` op."""
    return LineSearchResult(*linesearch_rollout_op(
        x_init, C, c, F, f, K, k, x_hat, u_hat, u_lower, u_upper, _opt(delta_u, float), *_model(dyn),
        float(decay), int(max_iter), use_cuda,
    ))


# ---------------------------------------------------------------------------
# The gradient: the KKT backward and the fixed point it differentiates.
# ---------------------------------------------------------------------------


def _kkt_kernel(C, c, F, r, tau, tight, reg, value_update_exact_reg, use_cuda):
    return _fresh(kkt_backward_fused(C, c, F, r, tau, tight, reg=reg, value_update_exact_reg=value_update_exact_reg,
                                     use_cuda=use_cuda), (C, c, F, r, tau, tight))


def _kkt_fake(C, c, F, r, tau, tight, *rest):
    T, B, n, nm = F.shape
    new = C.new_empty
    return new((B, n)), new((T, B, nm, nm)), new((T, B, nm)), new((T, B, n, nm)), new((T, B, n))


kkt_backward_op = _define(
    "kkt_backward(Tensor C, Tensor c, Tensor F, Tensor r, Tensor tau, Tensor tight, float reg, "
    "float value_update_exact_reg, bool? use_cuda) -> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    _kkt_kernel, _kkt_fake,
)


class _FixedPoint(torch.autograd.Function):
    """The autograd of ``diffmpc::lqr_fixed_point``: the op below autograd
    forward, the analytic KKT derivatives backward (the equations of
    :mod:`~diffmpc_tpu_torch.ops.lqr_step`): the tight box dims frozen, one
    ``kkt_backward`` op; nothing for the trajectory and the bounds."""

    @staticmethod
    def forward(ctx, x_init, C, c, F, f, x_star, u_star, u_lower, u_upper, constrained, tight_eps, back_eps,
                exact_reg, use_cuda):
        ctx.save_for_backward(C, c, F, x_star, u_star, u_lower, u_upper)
        ctx.knobs = (constrained, tight_eps, back_eps, exact_reg, use_cuda)
        with torch._C._AutoDispatchBelowAutograd():
            return lqr_fixed_point_op(x_init, C, c, F, f, x_star, u_star, u_lower, u_upper, constrained, tight_eps,
                                      back_eps, exact_reg, use_cuda)

    @staticmethod
    @once_differentiable
    def backward(ctx, gx, gu):
        C, c, F, x_star, u_star, u_lower, u_upper = ctx.saved_tensors
        constrained, tight_eps, back_eps, exact_reg, use_cuda = ctx.knobs
        if constrained:
            tight = (u_star <= u_lower + tight_eps) | (u_star >= u_upper - tight_eps)
        else:
            tight = torch.zeros_like(u_star, dtype=torch.bool)
        gu = torch.where(tight, torch.zeros_like(gu), gu)
        r = torch.cat([gx, gu], dim=-1)
        tau = torch.cat([x_star, u_star], dim=-1)
        dx_init, dC, dc, dF, df = kkt_backward_op(C, c, F, r, tau, tight, back_eps, exact_reg, use_cuda)
        return dx_init, dC, dc, dF, df, None, None, None, None, None, None, None, None, None


lqr_fixed_point_op = _define(
    "lqr_fixed_point(Tensor x_init, Tensor C, Tensor c, Tensor F, Tensor f, Tensor x_star, Tensor u_star, "
    "Tensor u_lower, Tensor u_upper, bool constrained, float tight_eps, float back_eps, "
    "float value_update_exact_reg, bool? use_cuda) -> (Tensor, Tensor)",
    lambda x_init, C, c, F, f, x_star, u_star, *rest: (x_star.clone(), u_star.clone()),
    lambda x_init, C, c, F, f, x_star, u_star, *rest: (torch.empty_like(x_star), torch.empty_like(u_star)),
    autograd=_FixedPoint.apply,
)


def lqr_fixed_point(x_init, C, c, F, f, x_star, u_star, u_lower, u_upper, *, constrained: bool,
                    tight_eps: float = 1e-6, back_eps: float = 1e-7, value_update_exact_reg: float = -1.0,
                    use_cuda: Optional[bool] = None):
    """The ``diffmpc::lqr_fixed_point`` op: ``(x_star, u_star)``, with the
    KKT derivatives with respect to ``x_init, C, c, F, f``; the bounds must
    have ``u_star``'s shape."""
    return lqr_fixed_point_op(x_init, C, c, F, f, x_star, u_star, u_lower, u_upper, bool(constrained),
                              float(tight_eps), float(back_eps), float(value_update_exact_reg), use_cuda)


# ---------------------------------------------------------------------------
# The non-fused loop's first rollout.
# ---------------------------------------------------------------------------


def _states(step, x_init, u):
    """The states ``(T, B, n)`` that ``u`` gives from ``x_init``, one
    ``step(t, x_t, u_t)`` at a time."""
    xs, x_t = [], x_init
    for t in range(u.shape[0]):
        xs.append(x_t)
        x_t = step(t, x_t, u[t])
    return torch.stack(xs)


def _rollout_states(x_init, u, F, f, model, statics, tensors):
    if F is not None:
        return _states(lambda t, x, ut: bmv(F[t], torch.cat([x, ut], -1)) + f[t], x_init, u)
    dx = spec.decode(model, statics, tensors)
    return _states(lambda t, x, ut: dx.forward(x, ut), x_init, u)


rollout_op = _define(
    "rollout(Tensor x_init, Tensor u, Tensor? F, Tensor? f, str model, str statics, Tensor[] tensors) -> Tensor",
    _rollout_states, _rollout_states,
)


def rollout(dx, x_init: Tensor, u: Tensor) -> Tensor:
    """The ``diffmpc::rollout`` op: the states of ``u`` from ``x_init``
    through ``dx`` (a ``LinDx`` of ``(T, B)`` tensors or a model), for a
    loop that takes no gradient through them. Export records one node where
    the steps would add some eight each (half of config 2's graph at
    T=128); the fake implementation is the same loop on fake tensors. A
    model the codec does not know is rolled out by the loop itself."""
    if isinstance(dx, LinDx):
        return rollout_op(x_init, u, dx.F, dx.f, "", "", [])
    if not spec.has_codec(dx):
        return _states(lambda t, x, ut: dx.forward(x, ut), x_init, u)
    name, statics, _, detached = _encoded(dx)
    return rollout_op(x_init, u, None, None, name, statics, detached)


# ---------------------------------------------------------------------------
# The linearization.
# ---------------------------------------------------------------------------


def _expand(model: str, statics: str, tensors, xs, us, method: str) -> tuple:
    return tuple(linearize_dynamics(spec.decode(model, statics, tensors), xs, us, GradMethods(method)))


def _linearize_kernel(model, statics, tensors, xs, us, method):
    return _fresh(_expand(model, statics, tensors, xs, us, method), (*tensors, xs, us))


def _linearize_autograd(model, statics, tensors, xs, us, method):
    """The linearization's autograd kernel. Where a gradient may be taken it
    computes the expansion in autograd, which records its graph as it goes:
    the backward is autograd's own and nothing is computed twice (a
    registered backward would expand again, ~0.6 ms of host time on the
    pendulum's host-bound imitation step). Otherwise it calls the kernel
    below autograd. Export records the op as one node, before autograd."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*tensors, xs, us)):
        return _expand(model, statics, tensors, xs, us, method)
    with torch._C._AutoDispatchBelowAutograd():
        return linearize_op(model, statics, tensors, xs, us, method)


def _linearize_fake(model, statics, tensors, xs, us, method):
    dtype = xs.dtype
    for t in [us, *tensors]:
        if t.is_floating_point():
            dtype = torch.promote_types(dtype, t.dtype)
    n, m = xs.shape[-1], us.shape[-1]
    return xs.new_empty((*xs.shape, n + m), dtype=dtype), xs.new_empty(xs.shape, dtype=dtype)


linearize_op = _define(
    "linearize(str model, str statics, Tensor[] tensors, Tensor xs, Tensor us, str method) -> (Tensor, Tensor)",
    _linearize_kernel, _linearize_fake, autograd=_linearize_autograd,
)


def linearize(dx, xs: Tensor, us: Tensor, method=GradMethods.ANALYTIC) -> LinDx:
    """:func:`~diffmpc_tpu_torch.ops.linearize.linearize_dynamics` through the
    ``diffmpc::linearize`` op (a ``LinDx`` is returned as it is):
    differentiable in the model's tensors and the trajectory. A model of a
    class the codec does not know cannot be rebuilt inside an op (nor
    exported): it is linearized by the function itself."""
    if isinstance(dx, LinDx):
        return dx
    if not spec.has_codec(dx):
        return linearize_dynamics(dx, xs, us, method)
    name, statics, tensors, _ = _encoded(dx)
    return LinDx(*linearize_op(name, statics, tensors, xs, us, GradMethods(method).value))
