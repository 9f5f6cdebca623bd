"""The depth-blocked unconstrained Riccati sweep: CUDA kernel wrapper and plain version.

Counterpart of
:func:`diffmpc_tpu.ops.pallas.riccati_blocked.riccati_backward_blocked_pallas`,
the TPU kernel that runs the free-mode Riccati recursion with adjacent
steps' value maps composed in blocks of ``D = 2`` or ``4``, so that its
serial chain is ``T / D`` applies (``csrc/riccati_blocked.cuh`` has the
algebra and the four phases). It computes what the free mode of
:func:`~diffmpc_tpu_torch.ops.cuda.riccati.riccati_backward_cuda` computes,
by another route.

- :func:`riccati_backward_blocked` is the entry point: CUDA tensors launch
  the kernel (or raise), CPU tensors run the plain version.
- :func:`riccati_backward_blocked_cuda` launches the kernel of
  ``csrc/riccati_blocked.cu`` (one thread per (block, scenario), the
  elements and boundary values on chip, no device scratch) and counts its
  launches.
- :func:`riccati_backward_blocked_plain` is the same algorithm in plain
  PyTorch, vectorized over the batch: each matrix entry is a ``(B,)`` tensor
  and Python loops run over the phases, steps and entries in the kernel's
  order. It serves CPU tensors and the checks of the kernel.

Both compute in float32 and return ``K, k`` in ``C.dtype``, ``free`` all
true and ``n_qp`` zeros, as the TPU wrapper does (``riccati_blocked.py:547-550``).
:mod:`diffmpc_tpu_torch.ops.assoc_riccati` is the same element algebra in
matrix form.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .ilqr import bm, kernel_symbol, resolve_use_cuda
from .riccati import (
    RiccatiResult,
    _check_shapes,
    _control_blocks,
    _entries,
    _free_gains,
    _q_form,
    _RiccatiArgs,
)
from .riccati_entries import _cho_solve_entries, _chol_entries


def _check_block(T: int, block: int) -> None:
    if block not in (2, 4):
        raise ValueError(f"block must be 2 or 4, got {block}")
    if T % block:
        raise ValueError(f"block={block} must evenly divide T={T}")


# ---------------------------------------------------------------------------
# The element algebra in entry form (csrc/riccati_blocked.cuh, in its order).
# An element is (A, b, C, eta, J): n x n, n, n x n, n, n x n lists of (B,)
# tensors.
# ---------------------------------------------------------------------------


def _solve_general_entries(M, cols, n):
    """Solve ``M x = col`` for each column with a general n x n matrix:
    Gaussian elimination without pivoting, then back substitution. Valid for
    the ``I + (PSD)(PSD)`` systems of this algebra (eigenvalues >= 1)."""
    a = [row[:] for row in M]
    x = [col[:] for col in cols]
    for k in range(n):
        inv = 1.0 / a[k][k]
        for j in range(k + 1, n):
            a[k][j] = a[k][j] * inv
        for col in x:
            col[k] = col[k] * inv
        for i in range(k + 1, n):
            fac = a[i][k]
            for j in range(k + 1, n):
                a[i][j] = a[i][j] - fac * a[k][j]
            for col in x:
                col[i] = col[i] - fac * col[k]
    for col in x:
        for i in reversed(range(n)):
            s = col[i]
            for j in range(i + 1, n):
                s = s - a[i][j] * col[j]
            col[i] = s
    return x


def _sym(X, n):
    return [[0.5 * (X[i][j] + X[j][i]) for j in range(n)] for i in range(n)]


def _build_element_entries(Ct, ct, Ft, ft, n, m, reg):
    """One step's element from its entry views (``Ct[a, b]``, ``ct[a]``,
    ``Ft[k, j]``, ``ft[k]`` or None)."""
    L = _chol_entries([[Ct[n + a, n + b] for b in range(m)] for a in range(m)], m, reg)
    iQ_Qux = [_cho_solve_entries(L, [Ct[n + a, j] for a in range(m)], m) for j in range(n)]
    iQ_qu = _cho_solve_entries(L, [ct[n + a] for a in range(m)], m)
    iQ_FuT = [_cho_solve_entries(L, [Ft[k, n + r] for r in range(m)], m) for k in range(n)]
    A = [[Ft[k, j] - sum(Ft[k, n + r] * iQ_Qux[j][r] for r in range(m)) for j in range(n)] for k in range(n)]
    b = [(ft[k] if ft is not None else 0.0) - sum(Ft[k, n + r] * iQ_qu[r] for r in range(m)) for k in range(n)]
    C = [[None] * n for _ in range(n)]
    J = [[None] * n for _ in range(n)]
    for k in range(n):
        for l in range(k, n):
            C[k][l] = C[l][k] = sum(Ft[k, n + r] * iQ_FuT[l][r] for r in range(m))
    for a in range(n):
        for c in range(a, n):
            J[a][c] = J[c][a] = Ct[a, c] - sum(Ct[a, n + r] * iQ_Qux[c][r] for r in range(m))
    eta = [-(ct[a] - sum(Ct[a, n + r] * iQ_qu[r] for r in range(m))) for a in range(n)]
    return A, b, C, eta, J


def _combine_entries(e1, e2, n):
    """Element ``e1`` then ``e2`` in time, with ``P = (I + C1 J2)^-1``."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    R = range(n)
    M = [[(1.0 if i == j else 0.0) + sum(C1[i][k] * J2[k][j] for k in R) for j in R] for i in R]
    x = _solve_general_entries(
        M,
        [[A1[i][j] for i in R] for j in R]
        + [[b1[i] + sum(C1[i][k] * eta2[k] for k in R) for i in R]]
        + [[C1[i][j] for i in R] for j in R],
        n,
    )
    Y = [[sum(x[n + 1 + l][k] * A2[j][l] for l in R) for j in R] for k in R]
    A = [[sum(A2[i][k] * x[j][k] for k in R) for j in R] for i in R]
    b = [sum(A2[i][k] * x[n][k] for k in R) + b2[i] for i in R]
    C = _sym([[sum(A2[i][k] * Y[k][j] for k in R) + C2[i][j] for j in R] for i in R], n)
    y = _solve_general_entries(
        [[M[j][i] for j in R] for i in R],
        [[eta2[i] - sum(J2[i][k] * b1[k] for k in R) for i in R]]
        + [[sum(J2[i][k] * A1[k][j] for k in R) for i in R] for j in R],
        n,
    )
    eta = [sum(A1[k][i] * y[0][k] for k in R) + eta1[i] for i in R]
    J = _sym([[sum(A1[k][i] * y[1 + j][k] for k in R) + J1[i][j] for j in R] for i in R], n)
    return A, b, C, eta, J


def _apply_element_entries(e, V, v, n):
    """Apply element ``e`` to the downstream value ``(V, v)``: one step, or
    one composed block, of the backward value recursion."""
    A, b, C, eta, J = e
    R = range(n)
    Nm = [[(1.0 if i == j else 0.0) + sum(V[i][k] * C[k][j] for k in R) for j in R] for i in R]
    x = _solve_general_entries(
        Nm,
        [[sum(V[i][k] * A[k][j] for k in R) for i in R] for j in R]
        + [[-v[i] - sum(V[i][k] * b[k] for k in R) for i in R]],
        n,
    )
    Vn = _sym([[sum(A[k][i] * x[j][k] for k in R) + J[i][j] for j in R] for i in R], n)
    vn = [-(sum(A[k][i] * x[n][k] for k in R) + eta[i]) for i in R]
    return Vn, vn


# ---------------------------------------------------------------------------
# The plain PyTorch version.
# ---------------------------------------------------------------------------


@torch.no_grad()
def riccati_backward_blocked_plain(
    C: torch.Tensor,
    c: torch.Tensor,
    F: torch.Tensor,
    f: Optional[torch.Tensor],
    n_state: int,
    *,
    block: int = 2,
    reg: float = 1e-9,
) -> RiccatiResult:
    """The depth-blocked sweep in plain PyTorch, on any device and for any
    ``(n, m)``, its four phases in the kernel's order; the contract of
    :func:`riccati_backward_blocked_cuda`."""
    n = n_state
    T, B, m = _check_shapes(C, c, F, f, n)
    _check_block(T, block)
    f32 = torch.float32
    Ce = C.to(f32).permute(0, 2, 3, 1)
    ce = c.to(f32).permute(0, 2, 1)
    Fe = F.to(f32).permute(0, 2, 3, 1)
    fe = None if f is None else f.to(f32).permute(0, 2, 1)
    zero = torch.zeros(B, dtype=f32, device=C.device)

    def fe_t(t):
        return None if fe is None else fe[t]

    # phase 1: the elements; phase 2: the composition tree within each block
    levels = [[_build_element_entries(Ce[t], ce[t], Fe[t], fe_t(t), n, m, reg) for t in range(T)]]
    while len(levels) < block.bit_length():
        below = levels[-1]
        levels.append([_combine_entries(below[2 * p], below[2 * p + 1], n) for p in range(len(below) // 2)])
    # phase 3 (serial): T / D applies, each block's right-boundary value kept
    P = T // block
    V, v = [[zero] * n for _ in range(n)], [zero] * n
    boundary = [None] * P
    for p in reversed(range(P)):
        boundary[p] = (V, v)
        V, v = _apply_element_entries(levels[-1][p], V, v, n)
    # phase 4: each block's gains, right to left from its boundary value
    K_all, k_all = [None] * T, [None] * T
    for p in range(P):
        V, v = boundary[p]
        for off in reversed(range(block)):
            t = p * block + off
            Q, q = _q_form(Ce[t], ce[t], _entries(Fe[t], n, n + m), fe_t(t), V, v, n, m)
            K, kt = _free_gains(*_control_blocks(Q, q, n, m), n, m, reg)
            K_all[t] = torch.stack([torch.stack(row, -1) for row in K], 1)
            k_all[t] = torch.stack(kt, 1)
            if off:
                V, v = _apply_element_entries(levels[0][t], V, v, n)
    dev = C.device
    return RiccatiResult(
        torch.stack(K_all).to(C.dtype),
        torch.stack(k_all).to(C.dtype),
        torch.ones((T, B, m), dtype=torch.bool, device=dev),
        torch.zeros((T, B), dtype=torch.int32, device=dev),
    )


# ---------------------------------------------------------------------------
# The CUDA kernel.
# ---------------------------------------------------------------------------


class _BlockedArgs(ctypes.Structure):
    """ctypes mirror of ``struct RiccatiBlockedArgs`` in
    ``csrc/riccati_blocked.cuh``."""

    _fields_ = [("ric", _RiccatiArgs), ("block", ctypes.c_int)]


def run_staged_blocked(launch, C, c, F, f, n_state, *, block=2, reg=1e-9) -> RiccatiResult:
    """Stage the inputs batch-minor, allocate the outputs, call
    ``launch(args, n, m)`` with a pointer to the ``RiccatiBlockedArgs``
    struct, and return the outputs in the public layout (``K, k`` float32).

    ``launch`` runs the blocked sweep over every (block, scenario) thread: the
    CUDA launcher for CUDA tensors, or a host build of the same header for CPU
    tensors (the tests do that). Float32 inputs only. Nothing but the inputs
    and outputs is allocated: the kernel keeps its elements and boundary
    values on chip."""
    n = n_state
    T, B, m = _check_shapes(C, c, F, f, n)
    _check_block(T, block)
    device = C.device
    for name, a in (("C", C), ("c", c), ("F", F), ("f", f)):
        if a is None:
            continue
        if a.dtype != torch.float32:
            raise TypeError(f"the blocked Riccati kernel takes float32 tensors; {name} is {a.dtype}")
        if a.device != device:
            raise ValueError(f"tensors on {a.device} and {device}")
    ins = dict(C=bm(C), c=bm(c), F=bm(F), f=None if f is None else bm(f))
    f32 = dict(dtype=torch.float32, device=device)
    K = torch.empty((T, m, n, B), **f32)
    k = torch.empty((T, m, B), **f32)
    free = torch.empty((T, m, B), **f32)
    ptr = {name: a.data_ptr() for name, a in ins.items() if a is not None}
    ric = _RiccatiArgs(**ptr, K=K.data_ptr(), k=k.data_ptr(), free=free.data_ptr(), T=T, B=B, pnqp_iter=0, reg=reg)
    launch(ctypes.byref(_BlockedArgs(ric=ric, block=block)), n, m)
    # The staged inputs are freed when this returns, while the kernel may
    # still run: PyTorch's caching allocator reuses a block only in stream
    # order, and the kernel runs on the current stream.
    return RiccatiResult(
        K.permute(0, 3, 1, 2),
        k.permute(0, 2, 1),
        free.permute(0, 2, 1) > 0.5,
        torch.zeros((T, B), dtype=torch.int32, device=device),
    )


@functools.lru_cache(maxsize=None)
def max_horizon(device: torch.device, n: int, m: int, block: int) -> int:
    """The longest horizon the kernel takes at ``(n, m)`` and ``block`` on
    ``device``: one CTA holds a scenario's ``T / block`` threads, so ``T /
    block`` is at most the kernel's threads a CTA at its registers, and
    their shared memory fits an SM's (``blocked_max_blocks``,
    ``csrc/riccati_blocked.cuh``)."""
    fn = kernel_symbol("riccati_blocked_max_blocks", n, m, [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    P = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(block, ctypes.byref(P))
    if err != 0:
        raise RuntimeError(f"riccati_blocked max_blocks query failed: cudaError {err}")
    return block * P.value


def _cuda_launcher(device: torch.device, n: int, m: int):
    """The kernel's launcher for ``(n, m)`` on the current stream; each launch
    adds one to :func:`riccati_backward_blocked_cuda`'s count. A horizon past
    :func:`max_horizon` raises ``ValueError`` before the launch."""
    fn = kernel_symbol("riccati_blocked", n, m, [ctypes.POINTER(_BlockedArgs), ctypes.c_void_p])
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch(args, n, m):
        a = args._obj
        longest = max_horizon(device, n, m, a.block)
        if a.ric.T > longest:
            raise ValueError(f"T={a.ric.T} is past the blocked kernel's longest horizon at (n, m)=({n}, {m}), "
                             f"block={a.block}: T <= {longest} (one CTA holds a scenario's T / block threads)")
        err = fn(args, stream)
        if err != 0:
            raise RuntimeError(f"riccati_blocked kernel launch failed: cudaError {err} (T={a.ric.T}, B={a.ric.B}, "
                               f"block={a.block})")
        riccati_backward_blocked_cuda.launches += 1

    return launch


def riccati_backward_blocked_cuda(
    C: torch.Tensor,
    c: torch.Tensor,
    F: torch.Tensor,
    f: Optional[torch.Tensor],
    n_state: int,
    *,
    block: int = 2,
    reg: float = 1e-9,
) -> RiccatiResult:
    """The depth-blocked sweep on the card: the contract of the JAX package's
    ``riccati_backward_blocked_pallas``. ``block`` is 2 or 4 and must divide
    ``T``, and ``T`` must not pass :func:`max_horizon` (a ``ValueError``
    names it). CUDA tensors of any float dtype: the kernel computes in
    float32 and ``K, k`` come back in ``C.dtype``. Adds one to
    ``riccati_backward_blocked_cuda.launches``; a shape outside the prebuilt
    table builds its variant at first use."""
    _, _, m = _check_shapes(C, c, F, f, n_state)
    _check_block(C.shape[0], block)
    resolve_use_cuda(True, C.device)
    f32 = torch.float32
    with torch.cuda.device(C.device):
        out = run_staged_blocked(
            _cuda_launcher(C.device, n_state, m), C.to(f32), c.to(f32), F.to(f32),
            None if f is None else f.to(f32), n_state, block=block, reg=reg,
        )
    return out._replace(K=out.K.to(C.dtype), k=out.k.to(C.dtype))


riccati_backward_blocked_cuda.launches = 0  # kernel launches, counted where they happen


def riccati_backward_blocked(
    C: torch.Tensor,
    c: torch.Tensor,
    F: torch.Tensor,
    f: Optional[torch.Tensor],
    n_state: int,
    *,
    block: int = 2,
    reg: float = 1e-9,
) -> RiccatiResult:
    """The depth-blocked sweep: the kernel for CUDA tensors (launched, or
    raising), the plain version for CPU tensors."""
    fn = riccati_backward_blocked_cuda if C.device.type == "cuda" else riccati_backward_blocked_plain
    return fn(C, c, F, f, n_state, block=block, reg=reg)
