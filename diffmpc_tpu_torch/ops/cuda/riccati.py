"""The Riccati backward sweep (free / box / mask): CUDA kernel wrapper and plain version.

Counterpart of :func:`diffmpc_tpu.ops.pallas.riccati.riccati_backward_pallas`,
the TPU kernel of the non-fused path's Riccati recursion over
``t = T-1 .. 0``, with the box QP inside (box mode) or given frozen control
dims (mask mode, the composite KKT backward).

- :func:`riccati_backward_cuda` launches the kernel of ``csrc/riccati.cu``
  (one thread per scenario) on CUDA tensors and counts its launches.
- :func:`riccati_backward_plain` is the same algorithm in plain PyTorch,
  vectorized over the batch: each matrix entry is a ``(B,)`` tensor and
  Python loops run over time and entries, in the kernel's order. It serves
  CPU tensors and the checks of the kernel.

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

from .ilqr import bm, kernel_symbol, resolve_use_cuda
from .riccati_entries import (
    _cho_solve_entries,
    _chol_entries,
    _masked_chol_solve,
    _pnqp_entries,
    _value_update,
)

FREE, BOX, MASK = 0, 1, 2  # enum RiccatiMode in csrc/riccati.cuh


class RiccatiResult(NamedTuple):
    K: torch.Tensor  # (T, B, m, n) feedback gains
    k: torch.Tensor  # (T, B, m) feedforward terms
    free_mask: torch.Tensor  # (T, B, m) bool: control dims not clamped
    n_qp_iter: torch.Tensor  # (T, B) int32: box-QP solves (0 when unused)


def _mode_inputs(T, B, m, u_lower, u_upper, u_hat, ctrl_mask):
    """The mode and its per-step input: ``(lo, hi)`` of the delta-u box
    (``lo = u_lower - u_hat``, as ``riccati.py:761-765``), the frozen mask,
    or nothing."""
    if u_lower is not None:
        if u_hat is None or ctrl_mask is not None:
            raise ValueError("box mode takes u_lower, u_upper and u_hat, and no ctrl_mask")
        shape = (T, B, m)
        return BOX, (u_lower.expand(shape) - u_hat, u_upper.expand(shape) - u_hat)
    if ctrl_mask is not None:
        return MASK, (ctrl_mask,)
    return FREE, ()


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
            kt, frozen, n_qp = _pnqp_entries(Quu, qu, lo, hi, m, pnqp_iter, reg)
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
        V, v = _value_update(Q, q, Quu, qu, K, kt, n, m)

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
    ] + [("T", ctypes.c_int), ("B", ctypes.c_int), ("pnqp_iter", ctypes.c_int), ("reg", ctypes.c_float)]


def run_staged_riccati(
    launch, C, c, F, f, n_state, *, u_lower=None, u_upper=None, u_hat=None,
    ctrl_mask=None, reg=1e-9, pnqp_iter=8,
) -> RiccatiResult:
    """Stage the inputs batch-minor, allocate the outputs, call
    ``launch(args, n, m, mode)`` with a pointer to the ``RiccatiArgs`` struct,
    and return the outputs in the public layout (``K, k`` float32).

    ``launch`` runs ``riccati_backward_scenario<n, m, mode>`` for every
    scenario: the CUDA launcher for CUDA tensors, or a host build of the same
    header for CPU tensors (the tests do that). Float32 inputs only
    (``ctrl_mask`` bool)."""
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
    K = torch.empty((T, m, n, B), **f32)
    k = torch.empty((T, m, B), **f32)
    free = torch.empty((T, m, B), **f32)
    n_qp = torch.zeros((T, B), **f32)
    ptr = {name: a.data_ptr() for name, a in ins.items() if a is not None}
    args = _RiccatiArgs(
        **ptr, K=K.data_ptr(), k=k.data_ptr(), free=free.data_ptr(), n_qp=n_qp.data_ptr(),
        T=T, B=B, pnqp_iter=pnqp_iter, reg=reg,
    )
    launch(ctypes.byref(args), n, m, mode)
    # The staged inputs are freed when this returns, while the kernel may
    # still run: PyTorch's caching allocator reuses a block only in stream
    # order, and the kernel runs on the current stream.
    return RiccatiResult(
        K.permute(0, 3, 1, 2),
        k.permute(0, 2, 1),
        free.permute(0, 2, 1) > 0.5,
        n_qp.to(torch.int32),
    )


def _cuda_launcher(device: torch.device, n: int, m: int, kind: str = "riccati", counted=None):
    """The launcher of kernel ``kind`` (``riccati`` or its streaming twin
    ``riccati_stream``: the same ``RiccatiArgs``) on the current stream; each
    launch adds one to ``counted.launches`` (default
    :func:`riccati_backward_cuda`)."""
    fn = kernel_symbol(kind, n, m, [ctypes.POINTER(_RiccatiArgs), ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream(device).cuda_stream
    counted = riccati_backward_cuda if counted is None else counted

    def launch(args, n, m, mode):
        err = fn(args, mode, stream)
        if err != 0:
            raise RuntimeError(f"{kind} kernel launch failed: cudaError {err}")
        counted.launches += 1

    return launch


def run_on_card(launcher, C, c, F, f, n_state, *, u_lower=None, u_upper=None, u_hat=None,
                ctrl_mask=None, reg=1e-9, pnqp_iter=8) -> RiccatiResult:
    """Run a Riccati kernel on CUDA tensors of any float dtype:
    ``launcher(device, n, m)`` gives the launch; the inputs are cast to
    float32 and ``K, k`` come back in ``C.dtype``. CPU tensors raise."""
    resolve_use_cuda(True, C.device)
    _, _, m = _check_shapes(C, c, F, f, n_state)
    dtype = C.dtype
    f32 = torch.float32

    def cast(a):
        return None if a is None or a.dtype == torch.bool else a.to(f32)

    with torch.cuda.device(C.device):
        out = run_staged_riccati(
            launcher(C.device, n_state, m), cast(C), cast(c), cast(F), cast(f), n_state,
            u_lower=cast(u_lower), u_upper=cast(u_upper), u_hat=cast(u_hat),
            ctrl_mask=ctrl_mask, reg=reg, pnqp_iter=pnqp_iter,
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
) -> RiccatiResult:
    """The Riccati sweep on the card: the contract of the JAX package's
    ``riccati_backward_pallas`` (box mode with ``u_lower, u_upper, u_hat``;
    mask mode with ``ctrl_mask``; free mode otherwise). CUDA tensors of any
    float dtype: the kernel computes in float32 and ``K, k`` come back in
    ``C.dtype``. Adds one to ``riccati_backward_cuda.launches``; shapes
    outside the kernels' ``(n, m)`` table raise."""
    return run_on_card(
        _cuda_launcher, C, c, F, f, n_state, u_lower=u_lower, u_upper=u_upper, u_hat=u_hat,
        ctrl_mask=ctrl_mask, reg=reg, pnqp_iter=pnqp_iter,
    )


riccati_backward_cuda.launches = 0  # kernel launches, counted where they happen
