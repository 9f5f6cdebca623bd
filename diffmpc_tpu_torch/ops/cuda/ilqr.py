"""The fused box-constrained iLQR solve: CUDA kernel wrapper and plain version.

Counterpart of :func:`diffmpc_tpu.ops.pallas.ilqr.ilqr_solve_fused`, the
TPU kernel that runs a whole iLQR solve per scenario (init rollout, then per
iteration: linearize the env step, delta-form Riccati sweep with the box QP,
alpha-ladder line search, replay and best-trajectory bookkeeping).

- :func:`ilqr_solve_fused` is the public entry point. For CUDA tensors it
  launches the kernel of ``csrc/ilqr.cu`` (a group of L threads per
  scenario, L by :func:`ilqr_lanes`), or of the variant built at first use
  for an MLP or a flag the prebuilt library lacks (:func:`kernel_library`),
  or raises; for CPU tensors it runs :func:`ilqr_solve_plain`.
- :func:`ilqr_solve_plain` is the same algorithm in plain PyTorch,
  vectorized over the batch: each entry is a ``(B,)`` tensor and Python
  loops run over time, iterations and entries. It computes in the dtype of
  ``x_init`` (the kernel, like the TPU kernel, in float32).

The public layout is the JAX wrapper's: ``C (T,B,nm,nm)``, ``c (T,B,nm)``,
``x_init (B,n)``, bounds broadcastable to ``(T,B,m)``, ``u_init (T,B,m)``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ...csrc.build import ENUM_DEFAULT, VariantKey
from ...models.dynamics import ACTIVATIONS, CtrlPassthroughDynamics, NNDynamics
from ...models.envs import AcrobotDx, CartpoleDx, PendulumDx, QuadrotorDx, VehicleDx
from .riccati_entries import _clip, _masked_chol_solve, _pnqp_entries, _value_update, pnqp_enum_flag, pnqp_is_exact


class FusedSolveResult(NamedTuple):
    xs: torch.Tensor  # (T, B, n)
    us: torch.Tensor  # (T, B, m)
    objs: torch.Tensor  # (B,)
    converged: torch.Tensor  # (B,) bool
    last_improvement: torch.Tensor  # (B,)
    alpha: torch.Tensor  # (B,)
    n_iters: torch.Tensor  # (B,) int32, iLQR iterations while active
    qp_iters: torch.Tensor  # (B,) mean box-QP solves (last active iteration)


def _check_shapes(x_init, C, c, u_lower, u_upper, u_init):
    if x_init.ndim != 2:
        raise ValueError(f"x_init must be (B, n); got {tuple(x_init.shape)}")
    B, n = x_init.shape
    if C.ndim != 4 or C.shape[1] != B or C.shape[2] != C.shape[3]:
        raise ValueError(f"C must be (T, B={B}, nm, nm); got {tuple(C.shape)}")
    T, nm = C.shape[0], C.shape[-1]
    m = nm - n
    if m < 1:
        raise ValueError(f"C's trailing dim {nm} leaves no control dims for n={n}")
    if tuple(c.shape) != (T, B, nm):
        raise ValueError(f"c must be {(T, B, nm)}; got {tuple(c.shape)}")
    for name, bound in (("u_lower", u_lower), ("u_upper", u_upper)):
        try:
            torch.broadcast_shapes(tuple(bound.shape), (T, B, m))
        except RuntimeError:
            raise ValueError(
                f"{name} must broadcast to {(T, B, m)}; got {tuple(bound.shape)}"
            ) from None
    if u_init is not None and tuple(u_init.shape) != (T, B, m):
        raise ValueError(f"u_init must be {(T, B, m)}; got {tuple(u_init.shape)}")
    return T, B, n, m


def fused_exact_update(m: int, reg: float, threshold: float, pnqp_enum: str = "") -> bool:
    """Whether the fused solve's box-mode sweep takes the simplified value
    update: the JAX kernel's gate (``ilqr.py:114``, ``_use_exact_value_update``
    in box mode) with ``VALUE_UPDATE_EXACT_REG`` as ``threshold``."""
    return pnqp_is_exact(True, m, pnqp_enum) and reg <= threshold


# ---------------------------------------------------------------------------
# The plain PyTorch version.
# ---------------------------------------------------------------------------


def _linearize(dyn, params, xh, uh, n, m):
    """Jacobian ``Ft[k][j] = d x_next[k] / d tau[j]`` of ``entries_step`` at
    ``(xh, uh)`` (``jax.linearize`` at ilqr.py:151 in the TPU kernel): one
    forward-mode pass (``torch.func.jvp``, which also runs inside a custom
    op's body, where the autograd keys are off) over the ``n + m`` columns
    side by side, the batch repeated once a column, column j's tangent one on
    its own block. Each entry computes what a probe of its column alone
    would, bit for bit."""
    nm = n + m
    B = xh[0].shape[0]
    block = torch.arange(nm, device=xh[0].device).repeat_interleave(B)
    prm = [p.repeat(nm) if p.ndim else p for p in params]
    primals = tuple(a.repeat(nm) for a in tuple(xh) + tuple(uh))
    tangents = tuple((block == j).to(a.dtype) for j, a in enumerate(primals))
    _, outs = torch.func.jvp(lambda *tau: tuple(dyn.entries_step(prm, list(tau[:n]), list(tau[n:]))), primals,
                             tangents)
    return [[outs[k].view(nm, B)[j] for j in range(nm)] for k in range(n)]


@torch.no_grad()
def ilqr_solve_plain(
    x_init: torch.Tensor,
    C: torch.Tensor,
    c: torch.Tensor,
    dyn,
    u_lower: torch.Tensor,
    u_upper: torch.Tensor,
    *,
    u_init: Optional[torch.Tensor] = None,
    lqr_iter: int = 10,
    pnqp_iter: int = 8,
    pnqp_enum: str = "",
    value_update_exact_reg: float = -1.0,
    reg: float = 1e-9,
    decay: float = 0.2,
    max_linesearch_iter: int = 10,
    delta_u: Optional[float] = None,
    eps: float = 1e-7,
    best_cost_eps: float = 1e-4,
    not_improved_lim: int = 5,
    hoist_lin: bool = False,
    unroll: bool = False,
) -> FusedSolveResult:
    """The fused solve in plain PyTorch, on any device; same contract as
    :func:`ilqr_solve_fused`, computed in ``x_init.dtype``. ``dyn`` provides
    ``kernel_params()`` and ``entries_step``. Scenarios that froze keep their
    state through ``where``; the loop stops once all have. ``hoist_lin``
    linearizes every step before the sweep instead of inside it: the same
    operations on the same values, so the same result bit for bit.
    ``unroll`` takes the ladder's step sizes as ``decay**k``, Python floats
    rounded once to the dtype, in place of the rolled ``alpha *= decay``."""
    T, B, n, m = _check_shapes(x_init, C, c, u_lower, u_upper, u_init)
    nm = n + m
    dtype = x_init.dtype
    exact = fused_exact_update(m, reg, value_update_exact_reg, pnqp_enum)
    # entry views: Ce[t, a, b] and friends are (B,) tensors
    Ce = C.to(dtype).permute(0, 2, 3, 1)
    ce = c.to(dtype).permute(0, 2, 1)
    lo = u_lower.to(dtype).expand(T, B, m).permute(0, 2, 1)
    hi = u_upper.to(dtype).expand(T, B, m).permute(0, 2, 1)
    ui = None if u_init is None else u_init.to(dtype).permute(0, 2, 1)
    # dense entries: forward-mode differentiation refuses a start expanded
    # over the batch (one memory location for every scenario)
    x0 = list(x_init.t().contiguous())
    params = dyn.kernel_params().to(dtype)
    params = list(params.t()) if params.ndim == 2 else list(params)
    zero = torch.zeros(B, dtype=dtype, device=x_init.device)
    one = torch.ones_like(zero)

    def step(x, u, params=params):
        return dyn.entries_step(params, x, u)

    def stage_cost(t, x, u, Ce=Ce, ce=ce):
        tau = x + u
        acc = None
        for a in range(nm):
            Ctau = sum(Ce[t, a, b] * tau[b] for b in range(nm))
            term = (0.5 * Ctau + ce[t, a]) * tau[a]
            acc = term if acc is None else acc + term
        return acc

    def control(t, x, alpha, uh, xh, k_g, K_g, lo=lo, hi=hi):
        u = []
        for a in range(m):
            acc = uh[t][a] + alpha * k_g[t][a]
            for j in range(n):
                acc = acc + K_g[t][a][j] * (x[j] - xh[t][j])
            if delta_u is not None:
                acc = _clip(acc, uh[t][a] - delta_u, uh[t][a] + delta_u)
            u.append(_clip(acc, lo[t, a], hi[t, a]))
        return u

    # The ladder's rollouts run side by side: every table repeated once a
    # step size along the batch, so that each entry computes what its
    # rollout alone would, bit for bit.
    n_alpha = max_linesearch_iter

    def tiled(v):
        return [tiled(e) for e in v] if isinstance(v, list) else v.repeat(n_alpha) if v.ndim else v

    Ce_l, ce_l = Ce.repeat(1, 1, 1, n_alpha), ce.repeat(1, 1, n_alpha)
    lo_l, hi_l = lo.repeat(1, 1, n_alpha), hi.repeat(1, 1, n_alpha)
    x0_l, params_l, zero_l = tiled(x0), tiled(params), zero.repeat(n_alpha)

    def ladder_objs(alphas):
        """Each scenario's objective at each step size of ``alphas``
        (``(n_alpha * B,)``, step size k on the k-th block): ``(n_alpha,
        B)``."""
        tables = tiled(uh), tiled(xh), tiled(k_g), tiled(K_g)
        x, obj = x0_l, zero_l
        for t in range(T):
            u = control(t, x, alphas, *tables, lo=lo_l, hi=hi_l)
            obj = obj + stage_cost(t, x, u, Ce_l, ce_l)
            x = step(x, u, params_l)
        return obj.view(n_alpha, B)

    # ---- initial trajectory: u_init (or zero) clamped into the box ----
    xh, uh = [], []
    x, obj = x0, zero
    for t in range(T):
        u = [_clip(ui[t, a] if ui is not None else zero, lo[t, a], hi[t, a]) for a in range(m)]
        xh.append(list(x))
        uh.append(u)
        obj = obj + stage_cost(t, x, u)
        x = step(x, u)
    bx, bu = [list(r) for r in xh], [list(r) for r in uh]
    cur_obj, best_obj = obj, obj
    done = torch.zeros_like(zero)
    n_not_improved = torch.zeros_like(zero)
    last_improvement = torch.full_like(zero, float("inf"))
    last_alpha = one
    n_iters = torch.zeros_like(zero)
    qp_iters = torch.zeros_like(zero)
    K_g, k_g = [None] * T, [None] * T

    for _ in range(lqr_iter):
        # the TPU kernel's early exit: iterate while any scenario is active
        if bool((done >= 0.5).all()):
            break
        active = done < 0.5
        # ---- Riccati backward sweep (delta form) ----
        def linearize_at(t):
            """The step's Jacobian ``Ft`` and the delta-form linear cost
            ``cd = c + C tau_hat``: neither reads the value carry."""
            Ft = _linearize(dyn, params, xh[t], uh[t], n, m)
            tau = xh[t] + uh[t]
            cd = [
                ce[t, a] + sum(Ce[t, a, b] * tau[b] for b in range(nm))
                for a in range(nm)
            ]
            return Ft, cd

        # the pre-pass of hoist_lin (the TPU kernel's pre_body, ilqr.py:234-249)
        hoisted = [linearize_at(t) for t in range(T)] if hoist_lin else None
        V = [[zero] * n for _ in range(n)]
        v = [zero] * n
        qp_sum = zero
        for t in reversed(range(T)):
            Ft, cd = hoisted[t] if hoist_lin else linearize_at(t)
            W = [
                [sum(V[k][l] * Ft[l][j] for l in range(n)) for j in range(nm)]
                for k in range(n)
            ]
            Q = [[None] * nm for _ in range(nm)]
            for a in range(nm):
                for b in range(a, nm):
                    val = Ce[t, a, b] + sum(Ft[k][a] * W[k][b] for k in range(n))
                    Q[a][b] = val
                    Q[b][a] = val
            q = [cd[a] + sum(Ft[k][a] * v[k] for k in range(n)) for a in range(nm)]
            Quu = [[Q[n + a][n + b] for b in range(m)] for a in range(m)]
            qu = [q[n + a] for a in range(m)]
            lo_d = [lo[t, a] - uh[t][a] for a in range(m)]
            hi_d = [hi[t, a] - uh[t][a] for a in range(m)]
            kt, frozen, n_qp = _pnqp_entries(Quu, qu, lo_d, hi_d, m, pnqp_iter, reg, pnqp_enum)
            qp_sum = qp_sum + n_qp
            rhs_cols = [[Q[n + a][b] for a in range(m)] for b in range(n)]
            K_cols = _masked_chol_solve(Quu, rhs_cols, frozen, m, reg)
            K_g[t] = [[-K_cols[b][a] for b in range(n)] for a in range(m)]
            k_g[t] = kt
            V, v = _value_update(Q, q, Quu, qu, K_g[t], kt, n, m, exact)
        qp_iters = torch.where(active, qp_sum / T, qp_iters)

        # ---- alpha ladder: first improving step per scenario; rolled, or
        # with unroll the exact powers (ilqr.py:336-348) ----
        alpha, alphas = torch.ones((), dtype=dtype, device=zero.device), []
        for a_idx in range(n_alpha):
            alphas.append(torch.full_like(zero, decay**a_idx) if unroll else alpha.expand(B))
            alpha = alpha * decay
        objs = ladder_objs(torch.cat(alphas))
        chosen = torch.full_like(zero, decay ** (n_alpha - 1))
        has = torch.zeros_like(zero, dtype=torch.bool)
        for a_idx in range(n_alpha):
            improving = (objs[a_idx] < cur_obj) & ~has
            chosen = torch.where(improving, alphas[a_idx], chosen)
            has = has | improving

        # ---- replay the chosen step; frozen scenarios keep theirs ----
        x, new_obj = x0, zero
        for t in range(T):
            u = control(t, x, chosen, uh, xh, k_g, K_g)
            xh[t] = [torch.where(active, x[a], xh[t][a]) for a in range(n)]
            uh[t] = [torch.where(active, u[a], uh[t][a]) for a in range(m)]
            new_obj = new_obj + stage_cost(t, x, u)
            x = step(x, u)
        cur_obj = torch.where(active, new_obj, cur_obj)

        improved = (new_obj < best_obj) & active
        improved_sig = (new_obj < best_obj - best_cost_eps) & active
        improvement = best_obj - new_obj
        for t in range(T):
            bx[t] = [torch.where(improved, xh[t][a], bx[t][a]) for a in range(n)]
            bu[t] = [torch.where(improved, uh[t][a], bu[t][a]) for a in range(m)]
        best_obj = torch.where(improved, new_obj, best_obj)
        n_not_improved = torch.where(improved_sig, zero, n_not_improved + active.to(dtype))
        last_improvement = torch.where(active, improvement, last_improvement)
        last_alpha = torch.where(active, chosen, last_alpha)
        n_iters = n_iters + active.to(dtype)
        newly_done = (improvement < eps) | (n_not_improved >= not_improved_lim)
        done = torch.maximum(done, newly_done.to(dtype))

    return FusedSolveResult(
        torch.stack([torch.stack(r, -1) for r in bx]),
        torch.stack([torch.stack(r, -1) for r in bu]),
        best_obj,
        last_improvement < eps,
        last_improvement,
        last_alpha,
        n_iters.to(torch.int32),
        qp_iters,
    )


# ---------------------------------------------------------------------------
# The CUDA kernel.
# ---------------------------------------------------------------------------


class _IlqrArgs(ctypes.Structure):
    """ctypes mirror of ``struct IlqrArgs`` in ``csrc/ilqr.cuh``."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "params", "C", "c", "x_init", "u_lower", "u_upper", "u_init",
            "xs", "us", "objs", "converged", "last_improvement", "alpha",
            "n_iters", "qp_iters", "x_hat", "u_hat", "K", "k",
        )
    ] + [
        (name, ctypes.c_int)
        for name in (
            "T", "B", "params_stride", "lqr_iter", "n_alpha",
            "not_improved_lim", "has_delta_u",
        )
    ] + [
        (name, ctypes.c_float)
        for name in (
            "reg", "decay", "alpha_floor", "delta_u", "eps", "best_cost_eps",
        )
    ] + [
        (name, ctypes.c_void_p) for name in ("F_s", "cd_s", "alphas", "lane_x", "lane_u")
    ] + [("lanes", ctypes.c_int), ("pnqp_iter", ctypes.c_int)]


class _PendulumEnv(ctypes.Structure):
    """ctypes mirror of ``struct PendulumEnv`` in ``csrc/pendulum.cuh``."""

    _fields_ = [
        ("max_torque", ctypes.c_float),
        ("max_speed", ctypes.c_float),
        ("dt", ctypes.c_float),
        ("clamp_ctrl", ctypes.c_int),
    ]


class _CartpoleEnv(ctypes.Structure):
    """ctypes mirror of ``struct CartpoleEnv`` in ``csrc/cartpole.cuh``."""

    _fields_ = [("dt", ctypes.c_float), ("max_force", ctypes.c_float), ("clamp_ctrl", ctypes.c_int)]


class _VehicleEnv(ctypes.Structure):
    """ctypes mirror of ``struct VehicleEnv`` in ``csrc/vehicle.cuh``."""

    _fields_ = [
        ("max_accel", ctypes.c_float),
        ("max_brake", ctypes.c_float),
        ("max_steer", ctypes.c_float),
        ("max_speed", ctypes.c_float),
        ("dt", ctypes.c_float),
        ("clamp_ctrl", ctypes.c_int),
    ]


class _QuadrotorEnv(ctypes.Structure):
    """ctypes mirror of ``struct QuadrotorEnv`` in ``csrc/quadrotor.cuh``."""

    _fields_ = [("max_thrust", ctypes.c_float), ("dt", ctypes.c_float), ("clamp_ctrl", ctypes.c_int)]


class _AcrobotEnv(ctypes.Structure):
    """ctypes mirror of ``struct AcrobotEnv`` in ``csrc/acrobot.cuh``."""

    _fields_ = [
        ("max_torque", ctypes.c_float),
        ("max_speed1", ctypes.c_float),
        ("max_speed2", ctypes.c_float),
        ("dt", ctypes.c_float),
        ("clamp_ctrl", ctypes.c_int),
    ]


class _NNEnv(ctypes.Structure):
    """ctypes mirror of the fields of ``struct NNEnv`` in
    ``csrc/nn_mlp.cuh``, the same for every architecture."""

    _fields_ = [("activation", ctypes.c_int), ("residual", ctypes.c_int)]


# The MLP architectures (n, m, hidden) the prebuilt library instantiates
# (csrc/nn_archs.cuh), each with its launchers diffmpc_<kind>_<nn_symbol(...)>:
# the JAX bench's 3-16-16-3 (bench.py:597) and the shapes of the JAX
# package's NN tests. Any other kernel-fusable MLP is a variant built at its
# first use (kernel_library).
NN_KERNEL_ARCHS = ((3, 1, (16, 16)), (3, 1, (8,)), (3, 1, (8, 8)), (3, 1, (16,)), (3, 2, (8,)))


def nn_symbol(n: int, m: int, hidden: tuple) -> str:
    return f"nn_n{n}m{m}_h" + "x".join(map(str, hidden))


class KernelEnv(NamedTuple):
    """What the kernels need of a model with a C++ step: its env struct, the
    suffix of its prebuilt launchers (``diffmpc_<kind>_<symbol>``; None where
    only a variant has it), its ``(n, m)``, the length ``P`` of its
    ``kernel_params``, whether they may be per-scenario ``(B, P)``, whether
    its step is cheap (the C++ env's ``kCheapStep``), which the fused
    kernel's lane groups and the lane rules read
    (:func:`keeps_lane_trajectories`, :func:`ilqr_lanes`, ``rollout_lanes``),
    its variant
    key's env and widths (a C++ env's name, ``pendulum`` or ``cartpole``
    among them, or ``nn`` with the MLP's hidden widths:
    :func:`kernel_library`), and whether the step is wrapped in
    ``CtrlPassthroughEnv`` (``csrc/passthrough.cuh``: ``(n, m)`` is then the
    wrapped shape; everything else is the inner env's)."""

    struct: ctypes.Structure
    symbol: Optional[str]
    n: int
    m: int
    n_params: int
    per_scenario: bool
    cheap_step: bool
    kind: str = "pendulum"
    hidden: tuple = ()
    passthrough: bool = False


# The envs with a C++ step of their own: model class -> its env struct (each
# field the model's attribute of the same name), its name (the variant key's
# env, csrc/build.py's CPP_ENVS: the struct's header csrc/<name>.cuh), the
# length P of its params, and the suffix of its prebuilt launchers (None:
# only its variants have them, built at first use). Every one of their steps
# is cheap (the headers' kCheapStep). Measured on an H100 (700 W) by
# diagnostics/ab_cheap_step.py, the acrobot's 106 operations, the most of the
# five, built both ways: cheap replays the chosen step as fast as keeping the
# lanes' trajectories (B = 16,384 at 2 lanes: 2.86 against 2.91 ms) and the
# line search's one pass at 1 lane beats rounds at 4 (16,384: 1.23 against
# 1.91 ms; 65,536: 3.02 against 7.08); the 3-16-16-3 MLP's ~770 are dear.
# Past the lanes' thread budget ilqr_lanes' 2 lanes for a cheap step, set by
# the pendulum's 25 operations, lose to 1 for the acrobot (65,536: 9.74
# against 8.06 ms).
_CPP_ENVS = {
    PendulumDx: (_PendulumEnv, "pendulum", 3, "pendulum"),
    CartpoleDx: (_CartpoleEnv, "cartpole", 4, None),
    VehicleDx: (_VehicleEnv, "vehicle", 2, None),
    QuadrotorDx: (_QuadrotorEnv, "quadrotor", 4, None),
    AcrobotDx: (_AcrobotEnv, "acrobot", 4, None),
}


def _cpp_env(dyn) -> KernelEnv:
    """The kernels' view of a model with a C++ step (:data:`_CPP_ENVS`):
    shared ``(P,)`` or per-scenario ``(B, P)`` params."""
    cls = type(dyn)
    struct_type, kind, n_params, symbol = _CPP_ENVS[cls]
    struct = struct_type(*(getattr(dyn, name) for name, _ in struct_type._fields_))
    return KernelEnv(struct, symbol, cls.n_state, cls.n_ctrl, n_params, True, True, kind)


def _nn_env(dyn: NNDynamics) -> KernelEnv:
    """The kernels' view of a kernel-fusable MLP: the prebuilt launchers of
    its architecture where :data:`NN_KERNEL_ARCHS` has it, else its variant's
    (any architecture the fusable gate takes, ``NNDynamics.kernel_fusable``)."""
    if not dyn.kernel_fusable:
        raise ValueError(
            f"the CUDA kernels take a kernel-fusable MLP (at most {dyn._FUSABLE_MAX_PARAMS} params, widths at "
            f"most {dyn._FUSABLE_MAX_WIDTH}); this one has {dyn.n_params} params and widths {dyn.hidden}"
        )
    arch = (dyn.n_state, dyn.n_ctrl, dyn.hidden)
    struct = _NNEnv(list(ACTIVATIONS).index(dyn.activation), int(dyn.residual))
    symbol = nn_symbol(*arch) if arch in NN_KERNEL_ARCHS else None
    return KernelEnv(struct, symbol, dyn.n_state, dyn.n_ctrl, dyn.n_params, False, False, "nn", dyn.hidden)


def _passthrough_env(dyn: CtrlPassthroughDynamics) -> KernelEnv:
    """The kernels' view of the slew penalty's augmented model: the inner
    model's env (its struct, params, lane rule and key) at the wrapped
    shape ``(n + m, m)``, launched only from its passthrough variant."""
    inner = kernel_env(dyn.inner)
    if inner.passthrough or inner.m != dyn.n_ctrl:
        raise ValueError(f"CtrlPassthroughDynamics(n_ctrl={dyn.n_ctrl}) wraps a model of m={inner.m} "
                         f"(passthrough={inner.passthrough}); the kernels take one wrap of its own m")
    return inner._replace(symbol=None, n=inner.n + inner.m, passthrough=True)


# model class -> its KernelEnv
_KERNEL_ENVS = {**{cls: _cpp_env for cls in _CPP_ENVS}, NNDynamics: _nn_env,
                CtrlPassthroughDynamics: _passthrough_env}


def kernel_env(dyn) -> KernelEnv:
    """The kernels' view of ``dyn``; raises ``NotImplementedError`` for a
    model without a C++ step."""
    make = _KERNEL_ENVS.get(type(dyn))
    if make is None:
        names = [cls.__name__ for cls in _KERNEL_ENVS if cls is not CtrlPassthroughDynamics]
        raise NotImplementedError(
            f"the CUDA kernels have a C++ step for {', '.join(names[:-1])} and {names[-1]} only, or "
            f"CtrlPassthroughDynamics around one of them, not {type(dyn).__name__}: a model rides them with a "
            "C++ step of its own (csrc/<env>.cuh, ops/cuda/ilqr.py's _CPP_ENVS)"
        )
    return make(dyn)


def env_variant_key(env: KernelEnv, family: str, enum: int = ENUM_DEFAULT, exact: bool = False):
    """The variant of ``family`` (``ilqr`` or ``rollout``) that launches
    ``env`` with the box QP's enumeration flag ``enum`` and the value
    update's form ``exact``, or None where the prebuilt library has its
    launchers (:func:`kernel_library`)."""
    if env.symbol is not None and enum == ENUM_DEFAULT and not exact:
        return None
    return VariantKey(family, env.n, env.m, env.kind, env.hidden, enum, bool(exact), env.passthrough)


def kernel_library(key: Optional[VariantKey]):
    """The library that holds a kernel's launchers: the prebuilt one for
    ``key`` None, else the variant's, built at its first use
    (``csrc/build.py``, ``load_variant``; a failed nvcc raises with its log).
    The variant's launchers are ``diffmpc_<kind>_variant``."""
    from ...csrc import build

    return build.load() if key is None else build.load_variant(key)


def check_kernel_params(env: KernelEnv, params: torch.Tensor, B: int, name: str) -> None:
    shapes = ((env.n_params,), (B, env.n_params)) if env.per_scenario else ((env.n_params,),)
    if tuple(params.shape) not in shapes:
        raise ValueError(f"{name} params must be one of {shapes}; got {tuple(params.shape)}")


def bm(a: torch.Tensor) -> torch.Tensor:
    """``(T, B, *trail) -> (T, *trail, B)``, contiguous: the kernels'
    batch-minor layout. A tensor already laid out so (such as a kernel's
    output viewed back in the public layout) is not copied."""
    return a.permute(0, *range(2, a.ndim), 1).contiguous()


def run_staged(
    launch,
    x_init, C, c, dyn, u_lower, u_upper, *,
    u_init=None, lqr_iter=10, pnqp_iter=8, reg=1e-9, decay=0.2, max_linesearch_iter=10,
    delta_u=None, eps=1e-7, best_cost_eps=1e-4, not_improved_lim=5, hoist_lin=False, unroll=False, lanes=1,
) -> FusedSolveResult:
    """Stage the inputs batch-minor, allocate the outputs and the scratch
    (with ``hoist_lin``, the pre-pass's ``F_s (T, n, nm, B)`` and
    ``cd_s (T, nm, B)`` too; with ``unroll``, the ladder's ``decay**k`` as
    float32; with ``lanes`` threads per scenario that keep their
    trajectories, :func:`keeps_lane_trajectories`, each lane's candidate
    trajectory ``(T, n, B, lanes)`` and ``(T, m, B, lanes)``), call
    ``launch(args, env)`` with pointers to the ``IlqrArgs`` (``lanes`` in
    it) and the env struct (:func:`kernel_env`), and return the outputs in
    the public layout.

    ``launch`` runs ``ilqr_solve_scenario`` for every scenario: the CUDA
    launcher for CUDA tensors, or a host build of the same headers for CPU
    tensors (the tests do that); it must be the one of ``hoist_lin`` and of
    the box QP's enumeration mode and the value update's form it is asked
    for (``pnqp_iter`` is the QP loop's steps). Float32 inputs only."""
    T, B, n, m = _check_shapes(x_init, C, c, u_lower, u_upper, u_init)
    env = kernel_env(dyn)
    if (n, m) != (env.n, env.m):
        raise ValueError(f"{type(dyn).__name__} is n={env.n}, m={env.m}; got n={n}, m={m}")
    params = dyn.kernel_params()
    tensors = [x_init, C, c, u_lower, u_upper, params]
    if u_init is not None:
        tensors.append(u_init)
    device = x_init.device
    for tsr in tensors:
        if tsr.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32 tensors; got {tsr.dtype}")
        if tsr.device != device:
            raise ValueError(f"tensors on {tsr.device} and {device}")
    check_kernel_params(env, params, B, type(dyn).__name__)

    C_k = bm(C)
    c_k = bm(c)
    lo_k = bm(u_lower.expand(T, B, m))
    hi_k = bm(u_upper.expand(T, B, m))
    ui_k = None if u_init is None else bm(u_init)
    x0_k = x_init.t().contiguous()
    p_k = params.contiguous()

    f32 = dict(dtype=torch.float32, device=device)
    xs = torch.empty((T, n, B), **f32)
    us = torch.empty((T, m, B), **f32)
    # objs, converged, impr, alpha, iters, qp: a buffer each, so that no two outputs share storage
    stats = [torch.empty(B, **f32) for _ in range(6)]
    x_hat = torch.empty((T, n, B), **f32)
    u_hat = torch.empty((T, m, B), **f32)
    K = torch.empty((T, m, n, B), **f32)
    k = torch.empty((T, m, B), **f32)
    F_s = torch.empty((T, n, n + m, B), **f32) if hoist_lin else None
    cd_s = torch.empty((T, n + m, B), **f32) if hoist_lin else None
    alphas = torch.tensor([decay**i for i in range(max_linesearch_iter)], **f32) if unroll else None
    keep = keeps_lane_trajectories(env, lanes)
    lane_x = torch.empty((T, n, B, lanes), **f32) if keep else None
    lane_u = torch.empty((T, m, B, lanes), **f32) if keep else None
    buffers = [C_k, c_k, lo_k, hi_k, x0_k, p_k, xs, us, *stats, x_hat, u_hat, K, k]
    buffers += [a for a in (ui_k, F_s, cd_s, alphas, lane_x, lane_u) if a is not None]
    for buf in buffers:
        if not buf.is_contiguous():  # pointers below assume dense layouts
            raise ValueError("staged kernel buffer is not contiguous")

    args = _IlqrArgs(
        params=p_k.data_ptr(), C=C_k.data_ptr(), c=c_k.data_ptr(),
        x_init=x0_k.data_ptr(), u_lower=lo_k.data_ptr(), u_upper=hi_k.data_ptr(),
        u_init=None if ui_k is None else ui_k.data_ptr(),
        xs=xs.data_ptr(), us=us.data_ptr(),
        objs=stats[0].data_ptr(), converged=stats[1].data_ptr(),
        last_improvement=stats[2].data_ptr(), alpha=stats[3].data_ptr(),
        n_iters=stats[4].data_ptr(), qp_iters=stats[5].data_ptr(),
        x_hat=x_hat.data_ptr(), u_hat=u_hat.data_ptr(), K=K.data_ptr(), k=k.data_ptr(),
        T=T, B=B, params_stride=env.n_params if p_k.ndim == 2 else 0,
        lqr_iter=lqr_iter, n_alpha=max_linesearch_iter,
        not_improved_lim=not_improved_lim, has_delta_u=int(delta_u is not None),
        reg=reg, decay=decay, alpha_floor=decay ** (max_linesearch_iter - 1),
        delta_u=0.0 if delta_u is None else delta_u, eps=eps,
        best_cost_eps=best_cost_eps,
        F_s=None if F_s is None else F_s.data_ptr(), cd_s=None if cd_s is None else cd_s.data_ptr(),
        alphas=None if alphas is None else alphas.data_ptr(),
        lane_x=None if lane_x is None else lane_x.data_ptr(),
        lane_u=None if lane_u is None else lane_u.data_ptr(), lanes=lanes, pnqp_iter=pnqp_iter,
    )
    launch(ctypes.byref(args), ctypes.byref(env.struct))
    # The staged inputs and the scratch are freed when this returns, while
    # the kernel may still run: PyTorch's caching allocator reuses a block
    # only in stream order, and the kernel runs on the current stream.
    return FusedSolveResult(
        xs.permute(0, 2, 1).contiguous(),
        us.permute(0, 2, 1).contiguous(),
        stats[0],
        stats[1] > 0.5,
        stats[2],
        stats[3],
        stats[4].to(torch.int32),
        stats[5],
    )


def run_staged_f32(launch, x_init, C, c, dyn, u_lower, u_upper, *, u_init=None, **knobs):
    """:func:`run_staged` for inputs of any float dtype: they are cast to
    float32 for the kernel, and ``xs, us, objs, last_improvement, alpha,
    qp_iters`` are cast back to ``x_init.dtype``, as the JAX wrapper does
    (``ilqr.py:520``, ``:603-610``)."""
    dtype = x_init.dtype
    f32 = torch.float32
    out = run_staged(
        launch, x_init.to(f32), C.to(f32), c.to(f32), dyn.to(f32), u_lower.to(f32), u_upper.to(f32),
        u_init=None if u_init is None else u_init.to(f32), **knobs,
    )
    return out._replace(**{
        f: getattr(out, f).to(dtype)
        for f in ("xs", "us", "objs", "last_improvement", "alpha", "qp_iters")
    })


# The lane counts the kernels are instantiated for (DMPC_LANES in
# csrc/lanes.cuh, the files csrc/ilqr_nn_l<L>.cu; the tests hold the three
# equal): those :func:`ilqr_lanes` picks, 1 among them.
ILQR_LANES = (1, 2, 4, 16)

# The rule's measurements: the kernel alone by CUDA events on an NVIDIA H100
# 80GB HBM3 at 700 W (132 SMs), ms at L = 1 / 2 / 4 / 16
# (diffmpc_tpu_torch.diagnostics.ab_ilqr_lanes; PERF.md, rows 1-1b):
#   pendulum, T=20, lqr_iter=10, B = 1024: 1.96 1.30 0.89 0.52;
#     4096: 2.02 1.33 0.89 0.94; 8192: 2.03 1.34 1.12 1.92;
#     16384: 2.17 1.63 1.71 3.27; 65536: 6.94 6.28 7.02 12.12;
#     with hoist_lin, 4096: 2.19 1.54 0.90 0.78; 16384: 2.82 2.17 1.75 2.69;
#     65536: 8.00 8.05 8.18 11.69;
#   the 3-16-16-3 MLP, T=15, lqr_iter=8, B = 1024: 8.12 4.70 3.23 1.87
#     (hoist_lin 8.14 4.28 2.59 1.01); 4096: 8.28 4.72 3.30 5.96 (8.22 4.27
#     2.65 1.88); 16384: 8.27 6.10 9.73 17.68 (8.54 5.57 5.03 7.10); 32768:
#     10.98 14.03 15.07 33.69 (11.22 8.49 9.86 13.96); 65536: 15.49 21.78
#     28.78 66.55 (16.11 16.70 19.34 27.73).
# More lanes pay while B * L threads leave the SMs idle: up to about 256
# threads an SM, twice that with hoist_lin, whose pre-pass the lanes share
# out. Past that the lanes' repeated sweep and idle ladder slots cost
# instruction slots instead. L = 8 is not built: it won only for the MLP at
# B = 2048-4096 in a build that replayed every step, by 7% over L = 16 and
# 14% over L = 4 (PERF.md).
LANE_THREADS_PER_SM = 256

# The variants (csrc/variants/ilqr.cu: the zoo, the passthrough wraps, the
# MLPs and flags outside the prebuilt tables) share each sweep step out over
# a group of 16 lanes (csrc/ilqr.cuh, riccati_sweep_shared), so 16 lanes pay
# up to more threads an SM for a cheap step whose sweep is not small
# (n + m >= 6). Measured on an NVIDIA H100 80GB HBM3 at 700 W
# (diagnostics/ab_ilqr_lanes.py --variants --wide; PERF.md, PR 21), ms at
# L = 1 / 2 / 4 / 16: at B = 4096 the cartpole 2.851 1.920 1.329 0.983, the
# vehicle's wrap 2.857 2.732 2.153 2.007, but the pendulum's, n + m = 5,
# 2.147 1.554 1.029 1.187; at 8192 every env fastest at 2 or 4 lanes; at
# 16,384 at 2 (the cartpole 5.270 3.130 3.560 3.951); at 65,536 two lanes
# only where the step and its sweep are small (m = 1, n + m <= 6: the
# cartpole 13.71 12.44, the pendulum's wrap 9.52 9.36), one elsewhere (the
# vehicle 11.06 11.27, the quadrotor 15.13 21.80, the acrobot 9.08 9.96,
# the vehicle's wrap 13.52 18.81).
SHARED_LANE_THREADS_PER_SM = 512


def keeps_lane_trajectories(env: KernelEnv, lanes: int) -> bool:
    """Whether the kernel's groups of ``lanes`` keep each lane's candidate
    trajectory instead of replaying the chosen step: at 16 lanes, and at
    every count above one for an env whose step is not cheap (an MLP's).
    This is ``ilqr_keeps_lanes`` of ``csrc/ilqr.cuh``; the kernel refuses a
    launch whose trajectory scratch disagrees with it."""
    return lanes >= 16 or (lanes > 1 and not env.cheap_step)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ilqr_lanes(B: int, env: KernelEnv, sm_count: int, hoist_lin: bool = False, shared: Optional[bool] = None) -> int:
    """The threads per scenario of the fused kernel for a batch of ``B``
    scenarios of ``env`` on a card of ``sm_count`` SMs: the most lanes that
    keep ``B * L`` within :data:`LANE_THREADS_PER_SM` threads an SM (twice
    that with ``hoist_lin``). Past that an env with a cheap step (the
    pendulum) keeps 2 lanes, its ladder's slices staged ahead (B = 65,536:
    6.32 ms against 7.00; the acrobot's step, four times the pendulum's, is
    faster at 1 there: :data:`_CPP_ENVS`), and one with a dear step (an
    MLP), whose sweep every lane would repeat, takes 1 (21.65 ms against
    15.43). A variant's kernel (``shared``; by default an env without
    prebuilt launchers) takes 16 lanes for a cheap step with n + m >= 6 up
    to :data:`SHARED_LANE_THREADS_PER_SM` threads an SM, and past the budget
    2 lanes only for a cheap step with m = 1 and n + m <= 6. The horizon
    does not enter: each step's slice is staged alike at every T."""
    shared = env.symbol is None if shared is None else shared
    if shared and env.cheap_step and env.n + env.m >= 6 and B * 16 <= SHARED_LANE_THREADS_PER_SM * sm_count:
        return 16
    budget = LANE_THREADS_PER_SM * (2 if hoist_lin else 1) * sm_count
    for lanes in (16, 4, 2):
        if B * lanes <= budget:
            return lanes
    if shared:
        return 2 if env.cheap_step and env.m == 1 and env.n + env.m <= 6 else 1
    return 2 if env.cheap_step else 1


def _cuda_launcher(device: torch.device, env: KernelEnv, hoist_lin: bool, pnqp_enum: str = "", exact: bool = False):
    """The fused kernel's launcher for :func:`run_staged`, which sets the
    threads per scenario in the args, for ``env`` with the box QP of
    ``pnqp_enum`` and the value update's form ``exact``: the prebuilt
    kernel, or the variant's (:func:`env_variant_key`); a lane count that is
    not built makes the launch fail, and the launcher raise. Each launch adds
    one to ``ilqr_solve_fused.launches`` and sets
    ``ilqr_solve_fused.last_lanes`` to the lane count it launched."""
    key = env_variant_key(env, "ilqr", pnqp_enum_flag(env.m, pnqp_enum), exact)
    suffix = env.symbol if key is None else "variant"
    fn = getattr(kernel_library(key), f"diffmpc_ilqr_solve_{suffix}" + ("_hoist" if hoist_lin else ""))
    fn.argtypes = [ctypes.POINTER(_IlqrArgs), ctypes.POINTER(type(env.struct)), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch(args, env_ref):
        err = fn(args, env_ref, stream)
        if err != 0:
            raise RuntimeError(f"ilqr kernel launch at {args._obj.lanes} lanes failed: cudaError {err} "
                               f"(lanes built: {ILQR_LANES})")
        ilqr_solve_fused.launches += 1
        ilqr_solve_fused.last_lanes = args._obj.lanes

    return launch


def resolve_use_cuda(use_cuda: Optional[bool], device: torch.device) -> bool:
    """The ``use_cuda`` rule: ``None`` takes the kernel for CUDA tensors and
    the plain version for CPU tensors; ``True`` demands the kernel and
    ``False`` the plain version, and a demand that does not fit the
    tensors' device raises."""
    on_cuda = device.type == "cuda"
    if use_cuda is None:
        return on_cuda
    if bool(use_cuda) != on_cuda:
        raise ValueError(
            f"use_cuda={use_cuda} with tensors on {device}: the CUDA kernel "
            "runs on CUDA tensors and its plain version on CPU tensors only"
        )
    return on_cuda


# The (n, m) shapes the prebuilt Riccati, rollout and KKT kernels are
# instantiated for, each with its own extern "C" launcher
# diffmpc_<kind>_n<n>m<m>: the pendulum (3, 1), and (3, 2), (4, 1), (4, 2)
# for the linear problems of BASELINE.json configs 1 and 2 and the box-DDP
# golden. Every other shape is a variant built at its first use.
KERNEL_SHAPES = ((3, 1), (3, 2), (4, 1), (4, 2))

# kind -> its variant family, and whether the family takes the box QP's
# enumeration flag and the value update's form
_KIND_FAMILY = {
    "riccati": ("riccati", True, False),
    "riccati_stream": ("riccati", True, False),
    "rollout": ("rollout", False, False),
    "rollout_stream": ("rollout", False, False),
    "kkt_backward": ("kkt", False, True),
    "kkt_backward_stream": ("kkt", False, True),
    "riccati_blocked": ("riccati_blocked", False, False),
    "riccati_blocked_max_blocks": ("riccati_blocked", False, False),
}


def kernel_variant_key(kind: str, n: int, m: int, *, enum: int = ENUM_DEFAULT, exact: bool = False):
    """The variant that holds kernel ``kind`` at ``(n, m)`` with the flags
    its family takes, or None where the prebuilt library has it."""
    family, takes_enum, takes_exact = _KIND_FAMILY[kind]
    enum = enum if takes_enum else ENUM_DEFAULT
    exact = bool(exact) and takes_exact
    if (n, m) in KERNEL_SHAPES and enum == ENUM_DEFAULT and not exact:
        return None
    return VariantKey(family, n, m, enum=enum, exact=exact)


def kernel_symbol(kind: str, n: int, m: int, argtypes: list, *, enum: int = ENUM_DEFAULT, exact: bool = False):
    """The launcher of kernel ``kind`` for ``(n, m)``, the box QP's
    enumeration flag ``enum`` (Riccati) and the value update's form
    ``exact`` (KKT), with its ctypes signature set (``argtypes``, an int
    return: the CUDA error code): from the prebuilt library for the shapes of
    :data:`KERNEL_SHAPES` and the default flags, else from its variant, built
    at first use (:func:`kernel_variant_key`)."""
    key = kernel_variant_key(kind, n, m, enum=enum, exact=exact)
    fn = getattr(kernel_library(key), f"diffmpc_{kind}_n{n}m{m}" if key is None else f"diffmpc_{kind}_variant")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def ilqr_solve_fused(
    x_init: torch.Tensor,
    C: torch.Tensor,
    c: torch.Tensor,
    dyn,
    u_lower: torch.Tensor,
    u_upper: torch.Tensor,
    *,
    u_init: Optional[torch.Tensor] = None,
    lqr_iter: int = 10,
    pnqp_iter: int = 8,
    pnqp_enum: str = "",
    value_update_exact_reg: float = -1.0,
    reg: float = 1e-9,
    decay: float = 0.2,
    max_linesearch_iter: int = 10,
    delta_u: Optional[float] = None,
    eps: float = 1e-7,
    best_cost_eps: float = 1e-4,
    not_improved_lim: int = 5,
    hoist_lin: bool = False,
    unroll: bool = False,
    use_cuda: Optional[bool] = None,
) -> FusedSolveResult:
    """Full fused iLQR solve; the contract of the JAX package's
    ``ilqr_solve_fused``. ``u_init (T,B,m)`` warm-starts the initial rollout;
    None starts from zero controls. ``pnqp_iter`` is the box QP loop's steps
    and ``pnqp_enum`` its enumeration mode (the JAX package's
    ``DIFFMPC_PNQP_ENUM``); ``value_update_exact_reg`` takes the simplified
    value update where the QP is exact (its ``VALUE_UPDATE_EXACT_REG``,
    :func:`fused_exact_update`). ``hoist_lin`` linearizes every step in a
    pre-pass before each Riccati sweep, off the value carry's chain (the JAX
    package's ``DIFFMPC_HOIST_LIN=1``): the same solve. A variant's lane
    groups (``csrc/ilqr.cuh``, ``riccati_sweep_shared``) linearize off the
    chain either way, in rounds of one step a lane. ``unroll`` takes the
    JAX package's exact-power ladder ``alpha = decay**k`` (its ``unroll=True``;
    the unrolled iteration loop changes no result).

    CUDA tensors launch the kernel of ``dyn``'s C++ step
    (:func:`kernel_env`; an MLP or a flag the prebuilt library lacks builds
    its variant at first use), which computes in float32 whatever the
    inputs' float dtype (the outputs come back in ``x_init.dtype``), and add
    one to ``ilqr_solve_fused.launches``; CPU tensors run
    :func:`ilqr_solve_plain`. See :func:`resolve_use_cuda`."""
    knobs = dict(
        u_init=u_init, lqr_iter=lqr_iter, pnqp_iter=pnqp_iter, reg=reg, decay=decay,
        max_linesearch_iter=max_linesearch_iter, delta_u=delta_u, eps=eps,
        best_cost_eps=best_cost_eps, not_improved_lim=not_improved_lim, hoist_lin=hoist_lin,
        unroll=unroll,
    )
    exact = fused_exact_update(C.shape[-1] - x_init.shape[-1], reg, value_update_exact_reg, pnqp_enum)
    if not resolve_use_cuda(use_cuda, x_init.device):
        return ilqr_solve_plain(
            x_init, C, c, dyn, u_lower, u_upper, pnqp_enum=pnqp_enum,
            value_update_exact_reg=value_update_exact_reg, **knobs
        )
    env = kernel_env(dyn)
    shared = env_variant_key(env, "ilqr", pnqp_enum_flag(env.m, pnqp_enum), exact) is not None
    lanes = ilqr_lanes(x_init.shape[0], env, _sm_count(x_init.device.index), hoist_lin, shared)
    with torch.cuda.device(x_init.device):
        launch = _cuda_launcher(x_init.device, env, hoist_lin, pnqp_enum, exact)
        return run_staged_f32(launch, x_init, C, c, dyn, u_lower, u_upper, lanes=lanes, **knobs)


ilqr_solve_fused.launches = 0  # kernel launches, counted where they happen
ilqr_solve_fused.last_lanes = None  # the lane count of the last launch
