"""Unrolled batched Cholesky for tiny SPD systems (counterpart of
:mod:`diffmpc_tpu.ops.smallchol`).

The matrix-form reference of the kernels' entry-wise factorizations: static
Python loops over the matrix dim ``m <= ~8``, elementwise arithmetic over
every leading batch dim. :mod:`diffmpc_tpu_torch.ops.pnqp` builds the box QP
on it.
"""

from __future__ import annotations

import torch


def cholesky_small(A: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Lower Cholesky factor of ``A (..., m, m)`` by the unrolled
    Cholesky-Crout recurrence."""
    m = A.shape[-1]
    if jitter:
        A = A + jitter * torch.eye(m, dtype=A.dtype, device=A.device)
    if m == 1:
        return torch.sqrt(A)
    cols = [[None] * m for _ in range(m)]  # cols[i][j] = L[..., i, j]
    for j in range(m):
        s = A[..., j, j]
        for k in range(j):
            s = s - cols[j][k] * cols[j][k]
        d = torch.sqrt(s)
        cols[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, m):
            s = A[..., i, j]
            for k in range(j):
                s = s - cols[i][k] * cols[j][k]
            cols[i][j] = s * inv_d
    zero = torch.zeros_like(A[..., 0, 0])
    rows = [torch.stack([cols[i][j] if j <= i else zero for j in range(m)], -1) for i in range(m)]
    return torch.stack(rows, -2)


def solve_tril_small(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L y = b`` (forward substitution); ``b (..., m, k)``."""
    m = L.shape[-1]
    ys = []
    for i in range(m):
        s = b[..., i, :]
        for k in range(i):
            s = s - L[..., i, k, None] * ys[k]
        ys.append(s / L[..., i, i, None])
    return torch.stack(ys, -2)


def solve_triu_small(L: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve ``L' x = y`` with lower-triangular ``L`` (back substitution)."""
    m = L.shape[-1]
    xs = [None] * m
    for i in reversed(range(m)):
        s = y[..., i, :]
        for k in range(i + 1, m):
            s = s - L[..., k, i, None] * xs[k]
        xs[i] = s / L[..., i, i, None]
    return torch.stack(xs, -2)


def cho_solve_small(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` given ``L = cholesky_small(A)``; ``b (..., m, k)``."""
    if L.shape[-1] == 1:
        return b / (L * L)
    return solve_triu_small(L, solve_tril_small(L, b))


def solve_psd_small(A: torch.Tensor, b: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Solve the SPD system ``A x = b`` for tiny static ``m``;
    ``b (..., m, k)``."""
    if A.shape[-1] == 1:
        if jitter:
            A = A + jitter
        return b / A
    return cho_solve_small(cholesky_small(A, jitter), b)


def solve_general_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a general (non-symmetric) tiny system ``A x = b`` by unrolled
    Gauss-Jordan elimination on the augmented rows, WITHOUT pivoting;
    ``b (..., m, k)``. For well-conditioned matrices with a dominant
    diagonal, such as the ``I + C J`` combiners of the parallel-in-time
    Riccati (eigenvalues >= 1 for PSD ``C, J``); not safe for arbitrary
    matrices."""
    m = A.shape[-1]
    if m == 1:
        return b / A
    rows = [torch.cat([A[..., i, :], b[..., i, :]], -1) for i in range(m)]
    for j in range(m):
        rows[j] = rows[j] / rows[j][..., j : j + 1]
        for i in range(m):
            if i != j:
                rows[i] = rows[i] - rows[i][..., j : j + 1] * rows[j]
    return torch.stack([rows[i][..., m:] for i in range(m)], -2)
