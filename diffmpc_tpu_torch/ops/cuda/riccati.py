"""The Riccati backward sweep (free / box / mask): CUDA kernel wrapper and plain version.

Counterpart of :func:`diffmpc_tpu.ops.pallas.riccati.riccati_backward_pallas`,
the TPU kernel of the non-fused path's Riccati recursion over
``t = T-1 .. 0``, with the box QP inside (box mode) or given frozen control
dims (mask mode, the composite KKT backward).

- :func:`riccati_backward_cuda` launches the kernel of ``csrc/riccati.cu``
  (a group of L threads per scenario sharing out each step's entries, QP
  candidates and gain columns, L by :func:`riccati_lanes`) on CUDA tensors
  and counts its launches.
- :func:`riccati_backward_plain` is the same algorithm in plain PyTorch,
  vectorized over the batch: each matrix entry is a ``(B,)`` tensor and
  Python loops run over time and entries, in the kernel's order. It serves
  CPU tensors and the checks of the kernel.

``pnqp_enum`` is the box QP's enumeration mode, the JAX package's
``DIFFMPC_PNQP_ENUM`` (:func:`~.riccati_entries.pnqp_enumerates`). With
``value_update_exact_reg`` at or above ``reg``, the sweep takes the JAX
package's simplified value update where its inner solve is exact
(:func:`use_exact_value_update`, the gate of ``riccati.py:509-513``); the
default -1 keeps the full form, as the JAX package's
``VALUE_UPDATE_EXACT_REG`` does. A shape outside the prebuilt table, or a
mode that changes the QP, launches a kernel built at its first use
(:func:`~.ilqr.kernel_symbol`).

The kernel computes in float32 and casts ``K, k`` back to ``C.dtype``, as
the TPU wrapper does (``riccati.py:754``, ``:796-797``); the plain version
computes in ``C.dtype``. The public layout is the
JAX function's: ``C (T,B,nm,nm)``, ``c (T,B,nm)``, ``F (T,B,n,nm)``,
``f (T,B,n)`` or None, bounds broadcastable to ``(T,B,m)``, ``u_hat`` and
``ctrl_mask`` ``(T,B,m)``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .ilqr import _sm_count, bm, kernel_symbol, resolve_use_cuda
from .riccati_entries import (
    _cho_solve_entries,
    _chol_entries,
    _masked_chol_solve,
    _pnqp_entries,
    _value_update,
    pnqp_enum_flag,
    pnqp_is_exact,
)

FREE, BOX, MASK = 0, 1, 2  # enum RiccatiMode in csrc/riccati.cuh


class RiccatiResult(NamedTuple):
    K: torch.Tensor  # (T, B, m, n) feedback gains
    k: torch.Tensor  # (T, B, m) feedforward terms
    free_mask: torch.Tensor  # (T, B, m) bool: control dims not clamped
    n_qp_iter: torch.Tensor  # (T, B) int32: box-QP solves (0 when unused)


def _mode_of(u_lower, u_hat, ctrl_mask) -> int:
    """The mode the arguments ask for: box with ``u_lower`` (and ``u_upper``,
    ``u_hat``), mask with ``ctrl_mask``, else free."""
    if u_lower is not None:
        if u_hat is None or ctrl_mask is not None:
            raise ValueError("box mode takes u_lower, u_upper and u_hat, and no ctrl_mask")
        return BOX
    return FREE if ctrl_mask is None else MASK


def _mode_inputs(T, B, m, u_lower, u_upper, u_hat, ctrl_mask):
    """The mode and its per-step input: ``(lo, hi)`` of the delta-u box
    (``lo = u_lower - u_hat``, as ``riccati.py:761-765``), the frozen mask,
    or nothing."""
    mode = _mode_of(u_lower, u_hat, ctrl_mask)
    if mode == BOX:
        shape = (T, B, m)
        return BOX, (u_lower.expand(shape) - u_hat, u_upper.expand(shape) - u_hat)
    return (MASK, (ctrl_mask,)) if mode == MASK else (FREE, ())


def use_exact_value_update(mode: int, m: int, reg: float, threshold: float, pnqp_enum: str = "") -> bool:
    """Whether a sweep takes the simplified value update: the gate of the
    JAX package's ``_use_exact_value_update`` (``riccati.py:509-513``) with
    its ``VALUE_UPDATE_EXACT_REG`` as ``threshold`` and its
    ``DIFFMPC_PNQP_ENUM`` as ``pnqp_enum``: the inner solve is exact
    (``_pnqp_is_exact``, ``:418-429``: free and mask modes, and in box mode
    the m = 1 closed form and the enumeration, but not the projected-Newton
    loop) and ``reg <= threshold``."""
    return pnqp_is_exact(mode == BOX, m, pnqp_enum) and reg <= threshold


def _check_shapes(C, c, F, f, n):
    if C.ndim != 4 or C.shape[2] != C.shape[3]:
        raise ValueError(f"C must be (T, B, nm, nm); got {tuple(C.shape)}")
    T, B, nm = C.shape[0], C.shape[1], C.shape[-1]
    m = nm - n
    if n < 1 or m < 1:
        raise ValueError(f"C's trailing dim {nm} does not split into n = {n} >= 1 and m >= 1")
    shapes = [("c", c, (T, B, nm)), ("F", F, (T, B, n, nm))]
    if f is not None:
        shapes.append(("f", f, (T, B, n)))
    for name, a, shape in shapes:
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(a.shape)}")
    return T, B, m


# ---------------------------------------------------------------------------
# The plain PyTorch version.
# ---------------------------------------------------------------------------


def _q_form(Ct, ct, F, ft, V, v, n, m):
    """One step's quadratic model from its entries (``Ct[a, b]``, ``ct[a]``,
    ``F[k][j]``, ``ft[k]`` or None: ``(B,)`` tensors) and the next value
    ``(V, v)``: ``W = V F``, ``z = V f + v``, ``Q = C + F'W`` (upper triangle,
    mirrored), ``q = c + F'z``, in the kernel's order (``riccati_q_form``)."""
    nm = n + m
    W = [[sum(V[k][l] * F[l][j] for l in range(n)) for j in range(nm)] for k in range(n)]
    z = [(sum(V[k][l] * ft[l] for l in range(n)) if ft is not None else 0.0) + v[k] for k in range(n)]
    Q = [[None] * nm for _ in range(nm)]
    for a in range(nm):
        for b in range(a, nm):
            val = Ct[a, b] + sum(F[k][a] * W[k][b] for k in range(n))
            Q[a][b] = val
            Q[b][a] = val
    q = [ct[a] + sum(F[k][a] * z[k] for k in range(n)) for a in range(nm)]
    return Q, q


def _entries(X, rows, cols):
    """A ``(rows, cols, B)`` view as a list of lists of ``(B,)`` entries."""
    return [[X[a, j] for j in range(cols)] for a in range(rows)]


def _control_blocks(Q, q, n, m):
    """``Quu``, ``qu`` and the columns of ``Qux`` of a step's model."""
    Quu = [[Q[n + a][n + b] for b in range(m)] for a in range(m)]
    qu = [q[n + a] for a in range(m)]
    cols = [[Q[n + a][b] for a in range(m)] for b in range(n)]
    return Quu, qu, cols


def _free_gains(Quu, qu, cols, n, m, reg):
    """Free-mode gains ``[K k] = -(Quu + reg)^-1 [Qux qu]``."""
    L = _chol_entries(Quu, m, reg)
    Kc = [_cho_solve_entries(L, col, m) for col in cols]
    K = [[-Kc[b][a] for b in range(n)] for a in range(m)]
    kt = [-x for x in _cho_solve_entries(L, qu, m)]
    return K, kt


@torch.no_grad()
def riccati_backward_plain(
    C: torch.Tensor,
    c: torch.Tensor,
    F: torch.Tensor,
    f: Optional[torch.Tensor],
    n_state: int,
    *,
    u_lower: Optional[torch.Tensor] = None,
    u_upper: Optional[torch.Tensor] = None,
    u_hat: Optional[torch.Tensor] = None,
    ctrl_mask: Optional[torch.Tensor] = None,
    reg: float = 1e-9,
    pnqp_iter: int = 8,
    pnqp_enum: str = "",
    value_update_exact_reg: float = -1.0,
    return_qp: bool = False,
):
    """The Riccati sweep in plain PyTorch, on any device and for any
    ``(n, m)``, in ``C.dtype``; same contract as
    :func:`riccati_backward_cuda`. With ``return_qp``, returns ``(result,
    Quu (T,B,m,m), qu (T,B,m))``: each step's control block of Q, by which a
    check of the kernel weighs the box QP's answers."""
    n = n_state
    T, B, m = _check_shapes(C, c, F, f, n)
    mode, extra = _mode_inputs(T, B, m, u_lower, u_upper, u_hat, ctrl_mask)
    exact = use_exact_value_update(mode, m, reg, value_update_exact_reg, pnqp_enum)
    dtype = C.dtype
    # entry views: Ce[t, a, b] and friends are (B,) tensors
    Ce = C.to(dtype).permute(0, 2, 3, 1)
    ce = c.to(dtype).permute(0, 2, 1)
    Fe = F.to(dtype).permute(0, 2, 3, 1)
    fe = None if f is None else f.to(dtype).permute(0, 2, 1)
    extra = [a.to(dtype).permute(0, 2, 1) for a in extra]
    zero = torch.zeros(B, dtype=dtype, device=C.device)

    K_all, k_all, free_all, nqp_all = [None] * T, [None] * T, [None] * T, [None] * T
    Quu_all, qu_all = [None] * T, [None] * T
    V = [[zero] * n for _ in range(n)]
    v = [zero] * n
    for t in reversed(range(T)):
        Q, q = _q_form(Ce[t], ce[t], _entries(Fe[t], n, n + m), None if fe is None else fe[t], V, v, n, m)
        Quu, qu, cols = _control_blocks(Q, q, n, m)
        n_qp = zero
        if mode == BOX:
            lo = [extra[0][t, a] for a in range(m)]
            hi = [extra[1][t, a] for a in range(m)]
            kt, frozen, n_qp = _pnqp_entries(Quu, qu, lo, hi, m, pnqp_iter, reg, pnqp_enum)
            Kc = _masked_chol_solve(Quu, cols, frozen, m, reg)
            K = [[-Kc[b][a] for b in range(n)] for a in range(m)]
        elif mode == MASK:
            frozen = [extra[0][t, a] for a in range(m)]
            sols = _masked_chol_solve(Quu, cols + [qu], frozen, m, reg)
            K = [[-sols[b][a] for b in range(n)] for a in range(m)]
            kt = [-sols[n][a] for a in range(m)]
        else:
            K, kt = _free_gains(Quu, qu, cols, n, m, reg)
            frozen = [zero] * m
        K_all[t] = torch.stack([torch.stack(row, -1) for row in K], 1)
        k_all[t] = torch.stack(kt, 1)
        free_all[t] = torch.stack([1.0 - fz for fz in frozen], 1) > 0.5
        nqp_all[t] = n_qp
        if return_qp:
            Quu_all[t] = torch.stack([torch.stack(row, -1) for row in Quu], 1)
            qu_all[t] = torch.stack(qu, 1)
        V, v = _value_update(Q, q, Quu, qu, K, kt, n, m, exact)

    out = RiccatiResult(
        torch.stack(K_all),
        torch.stack(k_all),
        torch.stack(free_all),
        torch.stack(nqp_all).to(torch.int32),
    )
    return (out, torch.stack(Quu_all), torch.stack(qu_all)) if return_qp else out


# ---------------------------------------------------------------------------
# The CUDA kernel.
# ---------------------------------------------------------------------------


class _RiccatiArgs(ctypes.Structure):
    """ctypes mirror of ``struct RiccatiArgs`` in ``csrc/riccati.cuh``."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in ("C", "c", "F", "f", "lo", "hi", "mask", "K", "k", "free", "n_qp")
    ] + [
        ("T", ctypes.c_int), ("B", ctypes.c_int), ("pnqp_iter", ctypes.c_int), ("reg", ctypes.c_float),
        ("lanes", ctypes.c_int), ("exact_update", ctypes.c_int), ("staged", ctypes.c_int),
    ]


# The lane counts the card's kernels are built for (DMPC_RICCATI_LANES in
# csrc/riccati_launch.cuh, the files csrc/riccati_l<L>.cu): the two that the
# rule below picks. The tests' host build also runs 2 and 4 (DMPC_LANES).
RICCATI_LANES = (1, 16)


# The rule's measurements: the kernels alone on every Riccati sweep of one
# mpc_solve, recorded, ms a call (summed over the calls over their count), by
# CUDA events on an NVIDIA H100 80GB HBM3 at 700 W (132 SMs), at L = 1 (device
# memory) / 1 (staged) / 16 (diffmpc_tpu_torch.diagnostics.ab_riccati_lanes;
# PERF.md, rows 3 and 5):
#   config 2 (n=4, m=2, box), T=20, B = 128: 0.0997 0.1064 0.0491;
#     4096: 0.1037 0.1080 0.0643; 16384: 0.1359 0.1096 0.2039;
#     65536: 0.1953 0.3403 0.7479;
#   the same at T=128 (the twin), B = 128: 0.6142 0.6553 0.2802;
#     4096: 0.7856 0.6576 0.3715; 16384: 0.8259 0.6625 1.2309;
#     65536: 1.1213 2.0658 4.5667;
#   the pendulum (n=3, m=1, box) with FINITE_DIFF, B=1024, T=20: 0.0215
#     0.0141 0.0215; T=256 (the twin): 0.4289 0.1320 0.2193.
# Sixteen lanes pay while B * 16 threads leave the card's SMs little else to
# do (512 threads an SM: 4096 scenarios on 132 SMs); two and four lanes
# (measured on an earlier build of the step) never beat both sixteen and
# one, and are not built. Past that one lane. The box
# mode's m = 1 step (a closed-form QP) is too short to share: one lane wins
# there at every batch measured. Whether one lane stages its slices is the
# launcher's choice (csrc/riccati_launch.cuh, one_lane_staged).
RICCATI_THREADS_PER_SM = 512


def riccati_lanes(B: int, n: int, m: int, mode: int, sm_count: int, T: int) -> int:
    """The threads per scenario of the Riccati kernels for a batch of ``B``
    scenarios at ``(n, m)`` in ``mode`` over ``T`` steps on a card of
    ``sm_count`` SMs: one for the box mode's m = 1 closed-form QP; else 16
    while ``B * 16`` stays within ``RICCATI_THREADS_PER_SM`` threads an SM,
    past that one. The horizon does not enter: the measurements at T=20 and
    128 (256 for the pendulum) pick alike."""
    if mode == BOX and m == 1:
        return 1
    return 16 if B * 16 <= RICCATI_THREADS_PER_SM * sm_count else 1


class StagedRiccati(NamedTuple):
    """A Riccati sweep staged for its kernels: the ``RiccatiArgs`` struct,
    the mode, the buffers the kernel writes and the tensors the struct points
    into, which must outlive every launch."""

    args: ctypes.Structure
    mode: int
    outputs: tuple  # K (T, m, n, B), k, free (T, m, B), n_qp (T, B)
    buffers: tuple

    def result(self) -> RiccatiResult:
        """The outputs of the last launch, in the public layout."""
        K, k, free, n_qp = self.outputs
        return RiccatiResult(K.permute(0, 3, 1, 2), k.permute(0, 2, 1), free.permute(0, 2, 1) > 0.5,
                             n_qp.to(torch.int32))


def stage_riccati(
    C, c, F, f, n_state, *, u_lower=None, u_upper=None, u_hat=None,
    ctrl_mask=None, reg=1e-9, pnqp_iter=8, pnqp_enum="", value_update_exact_reg=-1.0, lanes=1, staged=None,
) -> StagedRiccati:
    """Stage the inputs batch-minor and allocate the outputs for a launch of
    ``riccati_sweep<n, m, mode>`` for every scenario with ``lanes`` threads
    per scenario (at one lane each step's slice ``staged`` or read from
    device memory; None leaves it to the launcher, which writes its choice
    into the args) and the value update's form by
    :func:`use_exact_value_update`. The launch must be the kernel of
    ``pnqp_enum`` (:func:`~.riccati_entries.pnqp_enum_flag`). Float32 inputs
    only (``ctrl_mask`` bool)."""
    n = n_state
    T, B, m = _check_shapes(C, c, F, f, n)
    mode, extra = _mode_inputs(T, B, m, u_lower, u_upper, u_hat, ctrl_mask)
    device = C.device
    named = [("C", C), ("c", c), ("F", F)] + ([("f", f)] if f is not None else [])
    for name, a in named + list(zip(("lo", "hi"), extra if mode == BOX else ())):
        if a.dtype != torch.float32:
            raise TypeError(f"the Riccati kernel takes float32 tensors; {name} is {a.dtype}")
    if mode == MASK and ctrl_mask.dtype != torch.bool:
        raise TypeError(f"the Riccati kernel takes a bool ctrl_mask; got {ctrl_mask.dtype}")
    for a in [C, c, F, f, u_lower, u_upper, u_hat, ctrl_mask]:
        if a is not None and a.device != device:
            raise ValueError(f"tensors on {a.device} and {device}")

    ins = dict(C=bm(C), c=bm(c), F=bm(F), f=None if f is None else bm(f))
    if mode == BOX:
        ins["lo"], ins["hi"] = bm(extra[0]), bm(extra[1])
    elif mode == MASK:
        ins["mask"] = bm(ctrl_mask.to(torch.float32))
    f32 = dict(dtype=torch.float32, device=device)
    outputs = (
        torch.empty((T, m, n, B), **f32), torch.empty((T, m, B), **f32), torch.empty((T, m, B), **f32),
        torch.zeros((T, B), **f32),
    )
    args = _RiccatiArgs(
        **{name: a.data_ptr() for name, a in ins.items() if a is not None},
        **{name: a.data_ptr() for name, a in zip(("K", "k", "free", "n_qp"), outputs)},
        T=T, B=B, pnqp_iter=pnqp_iter, reg=reg, lanes=lanes,
        exact_update=int(use_exact_value_update(mode, m, reg, value_update_exact_reg, pnqp_enum)),
        staged=-1 if staged is None else int(staged),
    )
    return StagedRiccati(args, mode, outputs, tuple(ins.values()))


def run_staged_riccati(launch, C, c, F, f, n_state, **knobs) -> RiccatiResult:
    """Stage the inputs (:func:`stage_riccati`, with its knobs: the box,
    ``ctrl_mask``, ``reg``, ``pnqp_iter``, ``pnqp_enum``,
    ``value_update_exact_reg``, ``lanes`` and ``staged``), call
    ``launch(args, n, m, mode)`` with a pointer to the ``RiccatiArgs``
    struct, and return the outputs in the public layout (``K, k`` float32).

    ``launch`` runs ``riccati_sweep<n, m, mode>`` for every scenario: the
    CUDA launcher for CUDA tensors, or a host build of the same header for
    CPU tensors (the tests do that)."""
    staged = stage_riccati(C, c, F, f, n_state, **knobs)
    launch(ctypes.byref(staged.args), n_state, C.shape[-1] - n_state, staged.mode)
    # The staged inputs are freed when this returns, while the kernel may
    # still run: PyTorch's caching allocator reuses a block only in stream
    # order, and the kernel runs on the current stream.
    return staged.result()


def _cuda_launcher(device: torch.device, n: int, m: int, kind: str = "riccati", counted=None, lib=None,
                   pnqp_enum: str = ""):
    """The launcher of kernel ``kind`` (``riccati`` or its streaming twin
    ``riccati_stream``: the same ``RiccatiArgs``) with the box QP of
    ``pnqp_enum`` on the current stream, from the built library or the
    variant's (:func:`~.ilqr.kernel_symbol`), or from ``lib``, another build
    of the same sources; a lane count that is not built makes the launch
    fail, and the launcher raise.
    Each launch adds one to ``counted.launches`` (default
    :func:`riccati_backward_cuda`) and sets ``counted.last_lanes`` and
    ``counted.last_staged`` to the lane count it launched and whether it
    staged its slices."""
    argtypes = [ctypes.POINTER(_RiccatiArgs), ctypes.c_int, ctypes.c_void_p]
    fn = kernel_symbol(kind, n, m, argtypes, enum=pnqp_enum_flag(m, pnqp_enum))
    if lib is not None:
        fn = getattr(lib, fn.__name__)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream
    counted = riccati_backward_cuda if counted is None else counted

    def launch(args, n, m, mode):
        err = fn(args, mode, stream)
        if err != 0:
            raise RuntimeError(f"{kind} kernel launch failed: cudaError {err} (lanes built: {RICCATI_LANES})")
        counted.launches += 1
        counted.last_lanes = args._obj.lanes
        counted.last_staged = args._obj.lanes > 1 or args._obj.staged == 1

    return launch


def run_on_card(launcher, C, c, F, f, n_state, *, u_lower=None, u_upper=None, u_hat=None,
                ctrl_mask=None, reg=1e-9, pnqp_iter=8, pnqp_enum="", value_update_exact_reg=-1.0) -> RiccatiResult:
    """Run a Riccati kernel on CUDA tensors of any float dtype:
    ``launcher(device, n, m, pnqp_enum=...)`` gives the launch, at the lane count of
    :func:`riccati_lanes` (staged as the launcher chooses); the inputs are
    cast to float32 and ``K, k`` come back in ``C.dtype``. CPU tensors
    raise."""
    resolve_use_cuda(True, C.device)
    T, B, m = _check_shapes(C, c, F, f, n_state)
    lanes = riccati_lanes(B, n_state, m, _mode_of(u_lower, u_hat, ctrl_mask), _sm_count(C.device.index), T)
    dtype = C.dtype
    f32 = torch.float32

    def cast(a):
        return None if a is None or a.dtype == torch.bool else a.to(f32)

    with torch.cuda.device(C.device):
        out = run_staged_riccati(
            launcher(C.device, n_state, m, pnqp_enum=pnqp_enum), cast(C), cast(c), cast(F), cast(f), n_state,
            u_lower=cast(u_lower), u_upper=cast(u_upper), u_hat=cast(u_hat),
            ctrl_mask=ctrl_mask, reg=reg, pnqp_iter=pnqp_iter, pnqp_enum=pnqp_enum,
            value_update_exact_reg=value_update_exact_reg, lanes=lanes,
        )
    return out._replace(K=out.K.to(dtype), k=out.k.to(dtype))


def riccati_backward_cuda(
    C: torch.Tensor,
    c: torch.Tensor,
    F: torch.Tensor,
    f: Optional[torch.Tensor],
    n_state: int,
    *,
    u_lower: Optional[torch.Tensor] = None,
    u_upper: Optional[torch.Tensor] = None,
    u_hat: Optional[torch.Tensor] = None,
    ctrl_mask: Optional[torch.Tensor] = None,
    reg: float = 1e-9,
    pnqp_iter: int = 8,
    pnqp_enum: str = "",
    value_update_exact_reg: float = -1.0,
) -> RiccatiResult:
    """The Riccati sweep on the card: the contract of the JAX package's
    ``riccati_backward_pallas`` (box mode with ``u_lower, u_upper, u_hat``;
    mask mode with ``ctrl_mask``; free mode otherwise), with ``pnqp_enum``
    and ``value_update_exact_reg`` its module's ``DIFFMPC_PNQP_ENUM`` and
    ``VALUE_UPDATE_EXACT_REG``. CUDA tensors of any float dtype: the kernel
    computes in float32 and ``K, k`` come back in ``C.dtype``. Adds one to
    ``riccati_backward_cuda.launches`` and sets
    ``riccati_backward_cuda.last_lanes`` and ``.last_staged``; a shape or
    mode outside the prebuilt kernels builds its variant at first use."""
    return run_on_card(
        _cuda_launcher, C, c, F, f, n_state, u_lower=u_lower, u_upper=u_upper, u_hat=u_hat,
        ctrl_mask=ctrl_mask, reg=reg, pnqp_iter=pnqp_iter, pnqp_enum=pnqp_enum,
        value_update_exact_reg=value_update_exact_reg,
    )


riccati_backward_cuda.launches = 0  # kernel launches, counted where they happen
riccati_backward_cuda.last_lanes = None  # the lane count of the last launch
riccati_backward_cuda.last_staged = None  # whether the last launch staged its slices
