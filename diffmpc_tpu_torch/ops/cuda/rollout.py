"""The alpha-ladder line-search rollout: CUDA kernel wrapper and plain version.

Counterpart of :func:`diffmpc_tpu.ops.pallas.rollout.linesearch_rollout_pallas`,
the TPU kernel of the non-fused path's line search: the cost of the current
trajectory ``(x_hat, u_hat)`` as the accept baseline, the rolled ladder
``alpha = 1, alpha *= decay`` of ``max_iter`` closed-loop rollouts
``u = u_hat + alpha k + K (x - x_hat)`` (the ``delta_u`` clamp, then the
box), the first strictly improving step per scenario (else
``decay**(max_iter-1)``), and the replay of the chosen step.

- :func:`linesearch_rollout_cuda` launches the kernel of ``csrc/rollout.cu``
  (a group of L threads per scenario sharing out the ladder's candidates,
  L by :func:`rollout_lanes`) on CUDA tensors and counts its launches: linear
  dynamics from ``F, f``, or an env's own C++ step (the pendulum's, or the
  MLP's of a kernel-fusable ``NNDynamics``: ``ilqr.kernel_env``). With
  ``unroll`` it takes the JAX kernel's exact-power ladder ``decay**k``.
- :func:`linesearch_rollout_plain` is the same algorithm in plain PyTorch:
  each entry is a tensor over scenarios, the ladder's rollouts run side by
  side as a leading dim (elementwise, so each is the rollout the kernel
  runs), and the env step is its ``entries_step``. It serves CPU tensors and
  the checks of the kernel.

The kernel computes in float32 and casts the trajectory, costs and steps
back to ``x_init.dtype``; the plain version computes in ``x_init.dtype``.
The public layout is the JAX function's: ``x_init (B,n)``,
``C (T,B,nm,nm)``, ``c (T,B,nm)``, ``F (T,B,n,nm)``, ``f (T,B,n)`` or None,
``K (T,B,m,n)``, ``k (T,B,m)``, ``x_hat (T,B,n)``, ``u_hat (T,B,m)``, bounds
broadcastable to ``(T,B,m)``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .ilqr import (
    ILQR_LANES,
    LANE_THREADS_PER_SM,
    _sm_count,
    bm,
    check_kernel_params,
    env_variant_key,
    kernel_env,
    kernel_library,
    kernel_symbol,
    resolve_use_cuda,
)
from .riccati_entries import _clip


class LineSearchResult(NamedTuple):
    xs: torch.Tensor  # (T, B, n)
    us: torch.Tensor  # (T, B, m)
    objs: torch.Tensor  # (B,) accepted trajectory cost
    alpha: torch.Tensor  # (B,) accepted step size
    improved: torch.Tensor  # (B,) bool: strict improvement over (x_hat, u_hat)


def _check_shapes(x_init, C, c, F, f, K, k, x_hat, u_hat, u_lower, u_upper):
    if K.ndim != 4:
        raise ValueError(f"K must be (T, B, m, n); got {tuple(K.shape)}")
    T, B, m, n = K.shape
    nm = n + m
    shapes = [
        ("x_init", x_init, (B, n)), ("C", C, (T, B, nm, nm)), ("c", c, (T, B, nm)),
        ("k", k, (T, B, m)), ("x_hat", x_hat, (T, B, n)), ("u_hat", u_hat, (T, B, m)),
    ]
    if F is not None:
        shapes.append(("F", F, (T, B, n, nm)))
    if f is not None:
        shapes.append(("f", f, (T, B, n)))
    for name, a, shape in shapes:
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(a.shape)}")
    if (u_lower is None) != (u_upper is None):
        raise ValueError("u_lower and u_upper must be both set or both None")
    return T, B, n, m


# ---------------------------------------------------------------------------
# The plain PyTorch version.
# ---------------------------------------------------------------------------


@torch.no_grad()
def linesearch_rollout_plain(
    x_init: torch.Tensor,
    C: torch.Tensor,
    c: torch.Tensor,
    F: Optional[torch.Tensor],
    f: Optional[torch.Tensor],
    K: torch.Tensor,
    k: torch.Tensor,
    x_hat: torch.Tensor,
    u_hat: torch.Tensor,
    *,
    u_lower: Optional[torch.Tensor] = None,
    u_upper: Optional[torch.Tensor] = None,
    delta_u: Optional[float] = None,
    dyn=None,
    decay: float = 0.2,
    max_iter: int = 10,
    unroll: bool = False,
) -> LineSearchResult:
    """The line search in plain PyTorch, on any device, in ``x_init.dtype``;
    same contract as :func:`linesearch_rollout_cuda`, for any ``(n, m)`` and
    any env with ``entries_step`` (``dyn``; None takes the linear dynamics
    ``F, f``). ``unroll`` takes the ladder ``alpha = decay**k`` computed in
    double and rounded once (the JAX kernel's ``unroll=True``), not the
    rolled ``alpha *= decay``."""
    T, B, n, m = _check_shapes(x_init, C, c, F, f, K, k, x_hat, u_hat, u_lower, u_upper)
    nm = n + m
    dtype = x_init.dtype
    # entry views: Ce[t, a, b] and friends are (B,) tensors
    Ce = C.to(dtype).permute(0, 2, 3, 1)
    ce = c.to(dtype).permute(0, 2, 1)
    Ke = K.to(dtype).permute(0, 2, 3, 1)
    ke = k.to(dtype).permute(0, 2, 1)
    xh = x_hat.to(dtype).permute(0, 2, 1)
    uh = u_hat.to(dtype).permute(0, 2, 1)
    x0 = list(x_init.t())
    if u_lower is not None:
        lo = u_lower.to(dtype).expand(T, B, m).permute(0, 2, 1)
        hi = u_upper.to(dtype).expand(T, B, m).permute(0, 2, 1)
    if dyn is None:
        Fe = F.to(dtype).permute(0, 2, 3, 1)
        fe = None if f is None else f.to(dtype).permute(0, 2, 1)
    else:
        params = dyn.kernel_params().to(dtype)
        params = list(params.t()) if params.ndim == 2 else list(params)

    def stage_cost(t, x, u):
        tau = x + u
        acc = None
        for a in range(nm):
            Ctau = sum(Ce[t, a, b] * tau[b] for b in range(nm))
            term = (0.5 * Ctau + ce[t, a]) * tau[a]
            acc = term if acc is None else acc + term
        return acc

    def advance(t, x, u):
        if dyn is not None:
            return dyn.entries_step(params, x, u)
        tau = x + u
        out = [sum(Fe[t, a, b] * tau[b] for b in range(nm)) for a in range(n)]
        return out if fe is None else [out[a] + fe[t, a] for a in range(n)]

    def rollout(alpha, emit=None):
        """Costs of the rollouts at ``alpha`` (entries broadcast against
        it); with ``emit``, append each step's ``(x, u)`` to it."""
        x, obj = x0, 0.0
        for t in range(T):
            u = []
            for a in range(m):
                acc = uh[t, a] + alpha * ke[t, a]
                for j in range(n):
                    acc = acc + Ke[t, a, j] * (x[j] - xh[t, j])
                if delta_u is not None:
                    acc = _clip(acc, uh[t, a] - delta_u, uh[t, a] + delta_u)
                if u_lower is not None:
                    acc = _clip(acc, lo[t, a], hi[t, a])
                u.append(acc)
            if emit is not None:
                emit.append((x, u))
            obj = obj + stage_cost(t, x, u)
            x = advance(t, x, u)
        return obj

    obj0 = 0.0
    for t in range(T):
        obj0 = obj0 + stage_cost(t, list(xh[t]), list(uh[t]))
    # the ladder, its rollouts side by side: alphas (A, 1)
    if unroll:
        alphas = torch.tensor([decay**i for i in range(max_iter)], dtype=dtype, device=C.device)[:, None]
    else:
        alpha = torch.ones((), dtype=dtype, device=C.device)
        alphas = []
        for _ in range(max_iter):
            alphas.append(alpha)
            alpha = alpha * decay
        alphas = torch.stack(alphas)[:, None]
    improving = rollout(alphas) < obj0  # (A, B)
    has = improving.any(0)
    first = torch.argmax(improving.to(torch.int8), 0)
    floor = torch.full_like(alphas[0, 0], decay ** (max_iter - 1))
    chosen = torch.where(has, alphas[first, 0], floor)
    steps = []
    objs = rollout(chosen, steps)

    return LineSearchResult(
        torch.stack([torch.stack(x, -1) for x, _ in steps]),
        torch.stack([torch.stack(u, -1) for _, u in steps]),
        objs,
        chosen,
        has,
    )


# ---------------------------------------------------------------------------
# The CUDA kernel.
# ---------------------------------------------------------------------------


class _RolloutArgs(ctypes.Structure):
    """ctypes mirror of ``struct RolloutArgs`` in ``csrc/rollout.cuh``."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "params", "C", "c", "F", "f", "K", "k", "x_hat", "u_hat", "x_init",
            "u_lower", "u_upper", "xs", "us", "objs", "alpha", "improved",
        )
    ] + [
        (name, ctypes.c_int) for name in ("T", "B", "params_stride", "n_alpha", "has_delta_u")
    ] + [(name, ctypes.c_float) for name in ("decay", "alpha_floor", "delta_u")] + [
        (name, ctypes.c_void_p) for name in ("alphas", "lane_x", "lane_u")
    ] + [("lanes", ctypes.c_int)]


# The lane counts the kernels are instantiated for (DMPC_LANES in
# csrc/lanes.cuh, the files csrc/rollout_nn_l<L>.cu): the fused kernel's.
ROLLOUT_LANES = ILQR_LANES


def rollout_keeps_lane_trajectories(lanes: int) -> bool:
    """Whether the kernels' groups of ``lanes`` keep the trajectory of each
    lane's first candidate of a pass in a slot of their own,
    ``(T, n, B, lanes)`` and ``(T, m, B, lanes)``, so that picking one needs
    no replay: above one lane (one lane's slot is ``xs, us`` themselves).
    This is ``rollout_keeps_lanes`` of ``csrc/rollout.cuh``; the kernels
    refuse a launch whose trajectory scratch disagrees with it."""
    return lanes > 1


# The rule's measurements: the kernels alone on every line search of one
# mpc_solve, recorded and summed, by CUDA events on an NVIDIA H100 80GB HBM3
# at 700 W (132 SMs), ms at L = 1 / 2 / 4 / 16
# (diffmpc_tpu_torch.diagnostics.ab_rollout_lanes; PERF.md, rows 4 and 6):
#   config 2 (linear, n=4, m=2, box), T=20, B = 128: 0.588 0.511 0.409 0.504;
#     4096: 0.716 0.617 0.607 1.449; 16384: 1.164 1.486 2.135 5.174;
#     65536: 3.923 5.753 8.098 19.867;
#   the same at T=128 (the twin), B = 128: 8.277 6.349 5.070 6.333;
#     4096: 8.522 8.870 8.586 18.114; 16384: 14.304 18.949 28.466 74.323;
#     65536: 52.936 76.883 115.308 304.931;
#   the pendulum, T=20, B = 1024: 1.027 0.752 0.574 0.471; 65536: 2.955
#     2.784 3.632 7.282; T=256 (the twin), B = 1024: 12.316 9.338 6.827 3.678;
#   the 3-16-16-3 MLP, T=15, B = 1024: 7.318 3.820 2.549 1.344; 65536:
#     11.470 9.967 7.893 14.510; T=128 (the twin), B = 1024: 25.541 14.767
#     9.971 5.175; 65536: 50.118 39.229 36.205 80.665.
# More lanes pay while B * L threads leave the SMs idle (LANE_THREADS_PER_SM
# threads an SM, the fused kernel's budget). Past that a cheap step takes one
# lane, whose ten candidates share one pass, and an MLP's four, whose rounds
# of one candidate a lane are the fewer. For linear dynamics 16 lanes lose to
# 4 even on an idle card (0.504 against 0.409 ms): their step is too short to
# pay for the group's staging.
def rollout_lanes(B: int, env, sm_count: int, T: int) -> int:
    """The threads per scenario of the line-search kernels for a batch of
    ``B`` scenarios of ``env`` (a :class:`~.ilqr.KernelEnv`, or None for
    linear dynamics) over ``T`` steps on a card of ``sm_count`` SMs: the
    most lanes, of 16 and 4 (linear dynamics: 4), that keep ``B * L`` within
    ``LANE_THREADS_PER_SM`` threads an SM; past that one lane, or four for
    an env whose step is dear (an MLP's). The horizon does not enter: the
    measurements at T=20 and 128 (256 for the pendulum) pick alike."""
    budget = LANE_THREADS_PER_SM * sm_count
    for lanes in (4,) if env is None else (16, 4):
        if B * lanes <= budget:
            return lanes
    return 1 if env is None or env.cheap_step else 4


def _check_dyn(dyn, n, m):
    """The kernels' view of the dynamics: None for linear ones, else the
    env's :class:`~diffmpc_tpu_torch.ops.cuda.ilqr.KernelEnv` (raises for a
    model without a C++ step)."""
    if dyn is None:
        return None
    env = kernel_env(dyn)
    if (n, m) != (env.n, env.m):
        raise ValueError(f"{type(dyn).__name__} is n={env.n}, m={env.m}; got n={n}, m={m}")
    return env


class StagedRollout(NamedTuple):
    """A line search staged for its kernels: the ``RolloutArgs`` struct,
    the env struct (None for linear dynamics), the buffers the kernel writes
    and the tensors the struct points into, which must outlive every
    launch."""

    args: ctypes.Structure
    env: Optional[ctypes.Structure]
    outputs: tuple  # xs (T, n, B), us (T, m, B), stats (3, B): objs, alpha, improved
    buffers: tuple

    def result(self) -> LineSearchResult:
        """The outputs of the last launch, in the public layout."""
        xs, us, stats = self.outputs
        return LineSearchResult(xs.permute(0, 2, 1), us.permute(0, 2, 1), stats[0], stats[1], stats[2] > 0.5)


def stage_rollout(
    x_init, C, c, F, f, K, k, x_hat, u_hat, *, u_lower=None, u_upper=None,
    delta_u=None, dyn=None, decay=0.2, max_iter=10, unroll=False, lanes=1,
) -> StagedRollout:
    """Stage the inputs batch-minor and allocate the outputs (with
    ``unroll``, the ladder's ``decay**k`` as float32; where the groups of
    ``lanes`` threads keep their trajectories,
    :func:`rollout_keeps_lane_trajectories`, each lane's candidate trajectory
    ``(T, n, B, lanes)`` and ``(T, m, B, lanes)``), for a launch of
    ``linesearch_rollout_scenario`` for every scenario. Float32 inputs only.
    With an env (``ilqr.kernel_env``), ``F, f`` are not staged: the kernel
    does not read them."""
    T, B, n, m = _check_shapes(x_init, C, c, F, f, K, k, x_hat, u_hat, u_lower, u_upper)
    env = _check_dyn(dyn, n, m)
    if dyn is not None:
        F = f = None
    elif F is None:
        raise ValueError("linear dynamics need F")
    device = x_init.device
    named = dict(
        x_init=x_init, C=C, c=c, F=F, f=f, K=K, k=k, x_hat=x_hat, u_hat=u_hat,
        u_lower=u_lower, u_upper=u_upper,
        params=None if dyn is None else dyn.kernel_params(),
    )
    for name, a in named.items():
        if a is None:
            continue
        if a.dtype != torch.float32:
            raise TypeError(f"the rollout kernel takes float32 tensors; {name} is {a.dtype}")
        if a.device != device:
            raise ValueError(f"tensors on {a.device} and {device}")
    params = named.pop("params")
    if params is not None:
        check_kernel_params(env, params, B, type(dyn).__name__)

    ins = {
        name: None if a is None else bm(a.expand(T, B, m) if name in ("u_lower", "u_upper") else a)
        for name, a in named.items() if name != "x_init"
    }
    ins["x_init"] = x_init.t().contiguous()
    ins["params"] = None if params is None else params.contiguous()
    f32 = dict(dtype=torch.float32, device=device)
    xs = torch.empty((T, n, B), **f32)
    us = torch.empty((T, m, B), **f32)
    stats = torch.empty((3, B), **f32)  # objs, alpha, improved
    alphas = torch.tensor([decay**i for i in range(max_iter)], **f32) if unroll else None
    keep = rollout_keeps_lane_trajectories(lanes)
    lane_x = torch.empty((T, n, B, lanes), **f32) if keep else None
    lane_u = torch.empty((T, m, B, lanes), **f32) if keep else None
    args = _RolloutArgs(
        **{name: a.data_ptr() for name, a in ins.items() if a is not None},
        xs=xs.data_ptr(), us=us.data_ptr(), objs=stats[0].data_ptr(),
        alpha=stats[1].data_ptr(), improved=stats[2].data_ptr(),
        T=T, B=B, params_stride=params.shape[-1] if params is not None and params.ndim == 2 else 0,
        n_alpha=max_iter, has_delta_u=int(delta_u is not None), decay=decay,
        alpha_floor=decay ** (max_iter - 1), delta_u=0.0 if delta_u is None else delta_u,
        **{name: None if a is None else a.data_ptr() for name, a in (("alphas", alphas), ("lane_x", lane_x),
                                                                     ("lane_u", lane_u))},
        lanes=lanes,
    )
    buffers = (*ins.values(), alphas, lane_x, lane_u)
    return StagedRollout(args, None if env is None else env.struct, (xs, us, stats), buffers)


def run_staged_rollout(launch, *inputs, **knobs) -> LineSearchResult:
    """Stage the inputs (:func:`stage_rollout`, with its knobs), call
    ``launch(args, n, m, env)`` with a pointer to the ``RolloutArgs`` struct
    (``lanes`` in it) and, for an env, to its env struct (None for linear
    dynamics), and return the outputs in the public layout.

    ``launch`` runs ``linesearch_rollout_scenario`` for every scenario: the
    CUDA launcher for CUDA tensors, or a host build of the same header for
    CPU tensors (the tests do that)."""
    staged = stage_rollout(*inputs, **knobs)
    T, B, m, n = inputs[5].shape
    launch(ctypes.byref(staged.args), n, m, None if staged.env is None else ctypes.byref(staged.env))
    # The staged inputs are freed when this returns, while the kernel may
    # still run: PyTorch's caching allocator reuses a block only in stream
    # order, and the kernel runs on the current stream.
    return staged.result()


def _cuda_launcher(device: torch.device, n: int, m: int, dyn, kind: str = "rollout", counted=None, lib=None):
    """The launcher of kernel ``kind`` (``rollout`` or its streaming twin
    ``rollout_stream``: the same ``RolloutArgs``) for linear dynamics (``dyn``
    None) or an env's C++ step, on the current stream, from the built
    library (or ``lib``, another build of the same sources); a lane count
    that is not built makes the launch fail, and the launcher raise. Each
    launch adds one to ``counted.launches`` (default
    :func:`linesearch_rollout_cuda`) and sets ``counted.last_lanes`` to the
    lane count it launched."""
    stream = torch.cuda.current_stream(device).cuda_stream
    counted = linesearch_rollout_cuda if counted is None else counted
    if dyn is None:
        fn = kernel_symbol(kind, n, m, [ctypes.POINTER(_RolloutArgs), ctypes.c_void_p])
        if lib is not None:
            fn = getattr(lib, fn.__name__)
            fn.argtypes, fn.restype = [ctypes.POINTER(_RolloutArgs), ctypes.c_void_p], ctypes.c_int
    else:
        env = _check_dyn(dyn, n, m)
        key = env_variant_key(env, "rollout")
        suffix = env.symbol if key is None else "variant"
        fn = getattr(lib or kernel_library(key), f"diffmpc_{kind}_{suffix}")
        fn.argtypes = [ctypes.POINTER(_RolloutArgs), ctypes.POINTER(type(env.struct)), ctypes.c_void_p]
        fn.restype = ctypes.c_int

    def launch(args, n, m, env):
        err = fn(args, stream) if env is None else fn(args, env, stream)
        if err != 0:
            raise RuntimeError(f"{kind} kernel launch failed: cudaError {err} (lanes built: {ROLLOUT_LANES})")
        counted.launches += 1
        counted.last_lanes = args._obj.lanes

    return launch


def run_on_card(launcher, x_init, C, c, F, f, K, k, x_hat, u_hat, *, u_lower=None, u_upper=None,
                delta_u=None, dyn=None, decay=0.2, max_iter=10, unroll=False) -> LineSearchResult:
    """Run a line-search kernel on CUDA tensors of any float dtype:
    ``launcher(device, n, m, dyn)`` gives the launch, at the lane count of
    :func:`rollout_lanes`; the inputs are cast to float32 and
    ``xs, us, objs, alpha`` come back in ``x_init.dtype``. CPU tensors
    raise."""
    resolve_use_cuda(True, x_init.device)
    T, B, n, m = _check_shapes(x_init, C, c, F, f, K, k, x_hat, u_hat, u_lower, u_upper)
    env = _check_dyn(dyn, n, m)
    lanes = rollout_lanes(B, env, _sm_count(x_init.device.index), T)
    dtype = x_init.dtype
    f32 = torch.float32

    def cast(a):
        return None if a is None else a.to(f32)

    if dyn is not None:
        dyn = dyn.to(f32)
    with torch.cuda.device(x_init.device):
        out = run_staged_rollout(
            launcher(x_init.device, n, m, dyn),
            *map(cast, (x_init, C, c, F, f, K, k, x_hat, u_hat)),
            u_lower=cast(u_lower), u_upper=cast(u_upper), delta_u=delta_u, dyn=dyn,
            decay=decay, max_iter=max_iter, unroll=unroll, lanes=lanes,
        )
    return out._replace(**{name: getattr(out, name).to(dtype) for name in ("xs", "us", "objs", "alpha")})


def linesearch_rollout_cuda(
    x_init: torch.Tensor,
    C: torch.Tensor,
    c: torch.Tensor,
    F: Optional[torch.Tensor],
    f: Optional[torch.Tensor],
    K: torch.Tensor,
    k: torch.Tensor,
    x_hat: torch.Tensor,
    u_hat: torch.Tensor,
    *,
    u_lower: Optional[torch.Tensor] = None,
    u_upper: Optional[torch.Tensor] = None,
    delta_u: Optional[float] = None,
    dyn=None,
    decay: float = 0.2,
    max_iter: int = 10,
    unroll: bool = False,
) -> LineSearchResult:
    """The line search on the card: the contract of the JAX package's
    ``linesearch_rollout_pallas``, with ``dyn`` None for the linear dynamics
    ``F, f`` or a model with a C++ step (a ``PendulumDx`` or a kernel-fusable
    ``NNDynamics``, ``ilqr.kernel_env``) for its own step (``F, f`` are then
    not read), and ``unroll`` its exact-power ladder ``alpha = decay**k``.
    CUDA tensors of any float dtype: the kernel computes in float32 and
    ``xs, us, objs, alpha`` come back in ``x_init.dtype``. Adds one to
    ``linesearch_rollout_cuda.launches`` and sets
    ``linesearch_rollout_cuda.last_lanes``; other envs raise, and a linear
    shape or an MLP outside the prebuilt kernels builds its variant at first
    use (``ilqr.kernel_symbol``, ``ilqr.env_variant_key``)."""
    return run_on_card(
        _cuda_launcher, x_init, C, c, F, f, K, k, x_hat, u_hat, u_lower=u_lower, u_upper=u_upper,
        delta_u=delta_u, dyn=dyn, decay=decay, max_iter=max_iter, unroll=unroll,
    )


linesearch_rollout_cuda.launches = 0  # kernel launches, counted where they happen
linesearch_rollout_cuda.last_lanes = None  # the lane count of the last launch
