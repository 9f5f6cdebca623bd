"""The piece-decomposition kernels of the fused iLQR sweep: CUDA wrappers and plain versions.

Counterparts of the two kernel makers of ``scripts/profile_riccati_pieces.py``
in the JAX package's repository: ``make_sweep_kernel`` (the fused iLQR
kernel's delta-form Riccati step on the pendulum, with one piece stubbed in
a variant) and ``make_rollout_kernel`` (a T-step gain-feedback rollout),
each repeated ``reps`` times inside one kernel, the repetitions chained by a
seed. The cost of one sweep is the slope between two rep counts, and a
piece's cost the full sweep's slope less its variant's
(:mod:`diffmpc_tpu_torch.diagnostics.profile_riccati_pieces` measures them).

- :func:`sweep_piece_cuda` and :func:`rollout_piece_cuda` launch the kernels
  of ``csrc/riccati_pieces.cu`` (each by a group of ``lanes`` threads per
  scenario, as the fused kernel runs its sweep, each step's inputs read
  from device memory or ``staged`` through the group's shared memory;
  ``reps`` is a runtime argument, so every rep count runs one binary) and
  count their launches.
- :func:`sweep_piece_plain` and :func:`rollout_piece_plain` are the same
  arithmetic in plain PyTorch, each matrix entry a ``(B,)`` tensor, in the
  kernels' order. They serve CPU tensors and the checks of the kernels.

The inputs are the script's, in the public layout: the cost ``C (T,B,4,4)``,
``c (T,B,4)``, the trajectory ``x_hat (T,B,3)``, ``u_hat (T,B,1)``, the
box ``u_lower, u_upper`` broadcastable to ``(T,B,1)`` and the pendulum
``dyn`` (its params and step). Everything is computed in float32; the
plain versions also in float64, the witness of the kernels' rounding.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ...models.envs.pendulum import PendulumDx
from .ilqr import ILQR_LANES, _linearize, _PendulumEnv, _sm_count, bm, ilqr_lanes, kernel_env, resolve_use_cuda
from .riccati import _control_blocks, _q_form
from .riccati_entries import _clip, _masked_chol_solve, _pnqp_entries, _value_update

# the sweep's variants, in the order of enum PieceVariant (csrc/riccati_pieces.cuh)
VARIANTS = ("full", "no_lin", "no_Qform", "no_pnqp", "no_Vup")
N, M = 3, 1  # the pendulum
# the kernels' lane counts, one kernel file each (csrc/riccati_pieces_l<L>.cu):
# the fused kernel's, DMPC_LANES in csrc/lanes.cuh
PIECE_LANES = ILQR_LANES


class PieceSweepResult(NamedTuple):
    K: torch.Tensor  # (T, B, 1, 3) the last rep's gains
    k: torch.Tensor  # (T, B, 1), k[0] carrying the seed chain's end (times 1e-30)


class RolloutPieceResult(NamedTuple):
    obj: torch.Tensor  # (B,) the last rep's objective
    # (B,) the last rep's sum of |stage cost|: the scale the summation's
    # rounding of obj grows with, where obj itself may cancel to near zero
    abs_cost: torch.Tensor


def _entry_views(C, c, x_hat, u_hat, u_lower, u_upper, dtype=torch.float32):
    """Shape checks, and the entry views in ``dtype``: ``Ce[t, a, b]`` and
    friends are ``(B,)`` tensors."""
    if C.ndim != 4 or C.shape[2:] != (N + M, N + M):
        raise ValueError(f"C must be (T, B, 4, 4) (the pendulum, n=3, m=1); got {tuple(C.shape)}")
    T, B = C.shape[:2]
    for name, a, shape in (("c", c, (T, B, N + M)), ("x_hat", x_hat, (T, B, N)), ("u_hat", u_hat, (T, B, M))):
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(a.shape)}")
    views = dict(
        Ce=C.to(dtype).permute(0, 2, 3, 1), ce=c.to(dtype).permute(0, 2, 1),
        xh=x_hat.to(dtype).permute(0, 2, 1), uh=u_hat.to(dtype).permute(0, 2, 1),
        lo=u_lower.to(dtype).expand(T, B, M).permute(0, 2, 1), hi=u_upper.to(dtype).expand(T, B, M).permute(0, 2, 1),
    )
    return T, B, views


def _params(dyn, dtype=torch.float32):
    if not isinstance(dyn, PendulumDx):
        raise NotImplementedError(f"the piece kernels run the pendulum's step only, not {type(dyn).__name__}")
    params = dyn.kernel_params().to(dtype)
    if params.shape != (3,):
        raise ValueError(f"the piece kernels take shared (3,) pendulum params; got {tuple(params.shape)}")
    return params


# ---------------------------------------------------------------------------
# The plain PyTorch versions.
# ---------------------------------------------------------------------------


def _sweep_step(variant, dyn, params, e, t, V, v, reg):
    """One step ``t`` of the sweep in ``variant``: returns ``(K, kt, V', v')``
    (``sweep_step`` in csrc/riccati_pieces.cuh)."""
    n, m, nm = N, M, N + M
    Ce, ce = e["Ce"], e["ce"]
    tau = [e["xh"][t, i] for i in range(n)] + [e["uh"][t, i] for i in range(m)]
    if variant == "no_lin":
        Ft = [[V[k][k] * 1e-6 + (1.0 if j == k else 0.0) for j in range(nm)] for k in range(n)]
    else:
        Ft = _linearize(dyn, params, tau[:n], tau[n:], n, m)
    cd = [ce[t, a] + sum(Ce[t, a, b] * tau[b] for b in range(nm)) for a in range(nm)]
    if variant == "no_Qform":
        Q = [[Ce[t, a, b] + (V[0][0] * 1e-6 if a == b else 0.0) for b in range(nm)] for a in range(nm)]
        q = [cd[a] + Ft[0][a] * 1e-6 for a in range(nm)]
    else:  # the serial sweep's Q form, about the trajectory: c is cd, f is 0
        Q, q = _q_form(Ce[t], cd, Ft, None, V, v, n, m)
    Quu, qu, cols = _control_blocks(Q, q, n, m)
    if variant == "no_pnqp":
        inv = 1.0 / (Quu[0][0] + 1e-7)
        kt = [-qu[0] * inv]
        K = [[-cols[b][0] * inv for b in range(n)]]
    else:
        lo_d = [e["lo"][t, a] - tau[n + a] for a in range(m)]
        hi_d = [e["hi"][t, a] - tau[n + a] for a in range(m)]
        kt, frozen, _ = _pnqp_entries(Quu, qu, lo_d, hi_d, m, 8, reg)
        Kc = _masked_chol_solve(Quu, cols, frozen, m, reg)
        K = [[-Kc[b][a] for b in range(n)] for a in range(m)]
    if variant == "no_Vup":
        V = [[V[a][b] + (kt[0] * 1e-9 if a == b else 0.0) for b in range(n)] for a in range(n)]
        v = [v[a] + K[0][a] * 1e-9 for a in range(n)]
    else:
        V, v = _value_update(Q, q, Quu, qu, K, kt, n, m)
    return K, kt, V, v


@torch.no_grad()
def sweep_piece_plain(variant, C, c, x_hat, u_hat, u_lower, u_upper, dyn, *, reps=1, reg=1e-7,
                      dtype=torch.float32) -> PieceSweepResult:
    """The sweep kernel's arithmetic in plain PyTorch, on any device, in
    ``dtype``: ``reps`` sweeps over ``t = T-1 .. 0`` in ``variant``, each
    started from the last one's ``V[0][0]`` times 1e-30, that seed's end
    folded into ``k[0]`` (times 1e-30). Returns the last sweep's ``K, k``."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}; got {variant!r}")
    T, B, e = _entry_views(C, c, x_hat, u_hat, u_lower, u_upper, dtype)
    params = list(_params(dyn, dtype).to(C.device))
    seed = torch.zeros(B, dtype=dtype, device=C.device)
    K_all, k_all = [None] * T, [None] * T
    for _ in range(reps):
        init = seed * 1e-30
        V, v = [[init] * N for _ in range(N)], [init] * N
        for t in reversed(range(T)):
            K, kt, V, v = _sweep_step(variant, dyn, params, e, t, V, v, reg)
            K_all[t] = torch.stack([torch.stack(row, -1) for row in K], 1)
            k_all[t] = torch.stack(kt, 1)
        seed = V[0][0]
    k_all[0] = k_all[0] + (seed * 1e-30)[:, None]
    return PieceSweepResult(torch.stack(K_all), torch.stack(k_all))


@torch.no_grad()
def rollout_piece_plain(C, c, x_hat, u_hat, u_lower, u_upper, dyn, *, reps=1,
                        dtype=torch.float32) -> RolloutPieceResult:
    """The rollout kernel's arithmetic in plain PyTorch, on any device, in
    ``dtype``: ``reps`` closed-loop rollouts with ``u = clip(u_hat + 0.5 c_u
    + C_ux (x - x_hat), lo, hi)`` (the cost's entries stand in for the
    gains), each started from ``x_hat[0]`` plus the last objective times
    1e-30. Returns the last objective ``(B,)`` and its sum of |stage cost|."""
    n, m, nm = N, M, N + M
    T, B, e = _entry_views(C, c, x_hat, u_hat, u_lower, u_upper, dtype)
    Ce, ce, xh, uh = e["Ce"], e["ce"], e["xh"], e["uh"]
    params = list(_params(dyn, dtype).to(C.device))
    seed = torch.zeros(B, dtype=dtype, device=C.device)
    for _ in range(reps):
        x = [xh[0, i] + seed * 1e-30 for i in range(n)]
        obj = seed * 1e-30
        abs_cost = obj.abs()
        for t in range(T):
            u = []
            for a in range(m):
                acc = uh[t, a] + 0.5 * ce[t, n + a]
                for j in range(n):
                    acc = acc + Ce[t, n + a, j] * (x[j] - xh[t, j])
                u.append(_clip(acc, e["lo"][t, a], e["hi"][t, a]))
            tau = x + u
            acc = None
            for a in range(nm):
                term = (0.5 * sum(Ce[t, a, b] * tau[b] for b in range(nm)) + ce[t, a]) * tau[a]
                acc = term if acc is None else acc + term
            obj = obj + acc
            abs_cost = abs_cost + acc.abs()
            x = dyn.entries_step(params, x, u)
        seed = obj
    return RolloutPieceResult(obj, abs_cost)


# ---------------------------------------------------------------------------
# The CUDA kernels.
# ---------------------------------------------------------------------------


class _PieceArgs(ctypes.Structure):
    """ctypes mirror of ``struct PieceArgs`` in ``csrc/riccati_pieces.cuh``."""

    _fields_ = [
        (name, ctypes.c_void_p) for name in ("params", "C", "c", "x_hat", "u_hat", "lo", "hi", "K", "k", "obj")
    ] + [("T", ctypes.c_int), ("B", ctypes.c_int), ("reps", ctypes.c_int), ("reg", ctypes.c_float),
         ("lanes", ctypes.c_int), ("staged", ctypes.c_int)]


def piece_lanes(B: int, dyn, device) -> int:
    """The pieces' threads per scenario at a batch of ``B`` of the pendulum
    ``dyn`` on the card ``device``: the fused kernel's rule
    (:func:`~.ilqr.ilqr_lanes`), so that the pieces describe the main path's
    iteration."""
    return ilqr_lanes(B, kernel_env(dyn), _sm_count(torch.device(device).index or 0))


def _check_lanes(lanes: int) -> None:
    if lanes not in PIECE_LANES:
        raise ValueError(f"lanes must be one of {PIECE_LANES}; got {lanes}")


def run_staged_pieces(launch, variant, C, c, x_hat, u_hat, u_lower, u_upper, dyn, *, reps=1, reg=1e-7, lanes=1,
                      staged=False):
    """Stage the inputs batch-minor, allocate the outputs, call
    ``launch(args, env, variant)`` with pointers to the ``PieceArgs`` and
    ``PendulumEnv`` structs (``variant`` one of :data:`VARIANTS` or
    ``"rollout"``), and return the outputs in the public layout: a
    :class:`PieceSweepResult`, or the rollout's objective ``(B,)``. Each
    kernel runs ``lanes`` threads per scenario (one of :data:`PIECE_LANES`),
    each step's inputs ``staged`` through the group's shared memory or read
    from device memory.

    ``launch`` runs the kernel of that variant for every scenario: the CUDA
    launcher for CUDA tensors, or a host build of the same header for CPU
    tensors (the tests do that). Float32 inputs only."""
    if variant not in VARIANTS + ("rollout",):
        raise ValueError(f"variant must be one of {VARIANTS + ('rollout',)}; got {variant!r}")
    if reps < 1:
        raise ValueError(f"reps must be >= 1; got {reps}")
    _check_lanes(lanes)
    T, B, _ = _entry_views(C, c, x_hat, u_hat, u_lower, u_upper)
    params = _params(dyn)
    device = C.device
    for name, a in (("C", C), ("c", c), ("x_hat", x_hat), ("u_hat", u_hat), ("u_lower", u_lower),
                    ("u_upper", u_upper), ("params", params)):
        if a.dtype != torch.float32:
            raise TypeError(f"the piece kernels take float32 tensors; {name} is {a.dtype}")
        if a.device != device:
            raise ValueError(f"tensors on {a.device} and {device}")
    ins = dict(
        params=params.contiguous(), C=bm(C), c=bm(c), x_hat=bm(x_hat), u_hat=bm(u_hat),
        lo=bm(u_lower.expand(T, B, M)), hi=bm(u_upper.expand(T, B, M)),
    )
    f32 = dict(dtype=torch.float32, device=device)
    K, k = torch.empty((T, M, N, B), **f32), torch.empty((T, M, B), **f32)
    obj = torch.empty((B,), **f32)
    args = _PieceArgs(
        **{name: a.data_ptr() for name, a in ins.items()}, K=K.data_ptr(), k=k.data_ptr(), obj=obj.data_ptr(),
        T=T, B=B, reps=reps, reg=reg, lanes=lanes, staged=int(bool(staged)),
    )
    env = _PendulumEnv(dyn.max_torque, dyn.max_speed, dyn.dt, int(dyn.clamp_ctrl))
    launch(ctypes.byref(args), ctypes.byref(env), variant)
    # The staged inputs are freed when this returns, while the kernel may
    # still run: PyTorch's caching allocator reuses a block only in stream
    # order, and the kernel runs on the current stream.
    if variant == "rollout":
        return obj
    return PieceSweepResult(K.permute(0, 3, 1, 2), k.permute(0, 2, 1))


def _cuda_launcher(device: torch.device):
    """The launcher of both kernels on the current stream: each launch adds
    one to :func:`sweep_piece_cuda`'s or :func:`rollout_piece_cuda`'s count
    and sets its ``last_lanes``."""
    from ...csrc import build

    lib = build.load()
    sweep, rollout = lib.diffmpc_riccati_pieces_sweep, lib.diffmpc_riccati_pieces_rollout
    env_args = [ctypes.POINTER(_PieceArgs), ctypes.POINTER(_PendulumEnv)]
    sweep.argtypes = env_args + [ctypes.c_int, ctypes.c_void_p]
    rollout.argtypes = env_args + [ctypes.c_void_p]
    sweep.restype = rollout.restype = ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch(args, env, variant):
        if variant == "rollout":
            err, counted = rollout(args, env, stream), rollout_piece_cuda
        else:
            err, counted = sweep(args, env, VARIANTS.index(variant), stream), sweep_piece_cuda
        if err != 0:
            raise RuntimeError(f"riccati_pieces {variant} kernel launch failed: cudaError {err} "
                               f"(lanes {args._obj.lanes}; built: {PIECE_LANES})")
        counted.launches += 1
        counted.last_lanes = args._obj.lanes

    return launch


def _on_card(variant, C, c, x_hat, u_hat, u_lower, u_upper, dyn, *, lanes, **knobs):
    if lanes is not None:
        _check_lanes(lanes)
    resolve_use_cuda(True, C.device)
    if lanes is None:
        lanes = piece_lanes(C.shape[1], dyn, C.device)
    f32 = torch.float32
    dyn = dyn.replace(params=dyn.params.to(f32))
    with torch.cuda.device(C.device):
        return run_staged_pieces(
            _cuda_launcher(C.device), variant, C.to(f32), c.to(f32), x_hat.to(f32), u_hat.to(f32),
            torch.as_tensor(u_lower, dtype=f32, device=C.device), torch.as_tensor(u_upper, dtype=f32, device=C.device),
            dyn, lanes=lanes, **knobs,
        )


def sweep_piece_cuda(variant, C, c, x_hat, u_hat, u_lower, u_upper, dyn, *, reps=1, reg=1e-7, lanes=None,
                     staged=False) -> PieceSweepResult:
    """The sweep kernel on the card in ``variant`` (:data:`VARIANTS`),
    repeated ``reps`` times: the contract of :func:`sweep_piece_plain`. CUDA
    tensors of any float dtype, computed in float32, by ``lanes`` threads per
    scenario (None: :func:`piece_lanes`, the fused kernel's rule), each
    step's inputs ``staged`` through shared memory or read from device
    memory; every choice gives the same bits. Adds one to
    ``sweep_piece_cuda.launches``."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}; got {variant!r}")
    return _on_card(variant, C, c, x_hat, u_hat, u_lower, u_upper, dyn, reps=reps, reg=reg, lanes=lanes,
                    staged=staged)


def rollout_piece_cuda(C, c, x_hat, u_hat, u_lower, u_upper, dyn, *, reps=1, lanes=None,
                       staged=False) -> torch.Tensor:
    """The rollout kernel on the card, repeated ``reps`` times: the objective
    of :func:`rollout_piece_plain`. CUDA tensors of any float dtype, computed
    in float32, by ``lanes`` threads per scenario (None: :func:`piece_lanes`,
    the fused kernel's rule), each step's inputs ``staged`` through shared
    memory or read from device memory; every choice gives the same bits.
    Adds one to ``rollout_piece_cuda.launches``."""
    return _on_card("rollout", C, c, x_hat, u_hat, u_lower, u_upper, dyn, reps=reps, lanes=lanes, staged=staged)


sweep_piece_cuda.launches = 0  # kernel launches, counted where they happen
sweep_piece_cuda.last_lanes = None  # the threads per scenario of the last sweep launched
rollout_piece_cuda.launches = 0
rollout_piece_cuda.last_lanes = None
