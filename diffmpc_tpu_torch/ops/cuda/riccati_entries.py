"""Per-step Riccati helpers of the kernels, in plain PyTorch.

Counterparts of the entry-tile helpers of
:mod:`diffmpc_tpu.ops.pallas.riccati` (``_chol_entries``,
``_cho_solve_entries``, ``_masked_chol_solve``, the box QP
``_pnqp_entries`` with its enumeration ``_pnqp_enum_entries`` under each
mode of ``DIFFMPC_PNQP_ENUM``, here the keyword ``pnqp_enum``, and
``_value_update`` in its full and its simplified form). Every matrix entry
is a ``(B,)`` tensor over scenarios and the small matrices are lists of
them, so the arithmetic is the
same, entry by entry and in the same order, as the device functions of
``csrc/riccati_entries.cuh`` that the CUDA kernels run.
"""

from __future__ import annotations

import itertools

import torch

from ...csrc.build import ENUM_DEFAULT, ENUM_LOOP, ENUM_THREE

# The box QP's enumeration modes, the JAX package's DIFFMPC_PNQP_ENUM
# (riccati.py:301-341): "" enumerates the active sets at m = 2, "0" takes the
# projected-Newton loop at m = 2 as well, "1" enumerates at m = 3 too.
PNQP_ENUM_MODES = ("", "0", "1")


def check_pnqp_enum(mode: str) -> str:
    """``mode`` if it is one of :data:`PNQP_ENUM_MODES`; else ``ValueError``."""
    if mode not in PNQP_ENUM_MODES:
        raise ValueError(f"pnqp_enum must be one of {PNQP_ENUM_MODES}; got {mode!r}")
    return mode


def pnqp_enumerates(m: int, mode: str) -> bool:
    """Whether the box QP of ``m`` dims enumerates its active sets under
    ``mode`` (``_pnqp_entries``'s dispatch, ``riccati.py:339-341``)."""
    check_pnqp_enum(mode)
    return (m == 2 and mode != "0") or (m == 3 and mode == "1")


def pnqp_is_exact(box: bool, m: int, mode: str) -> bool:
    """Whether the inner control solve is the exact optimum of its QP: the
    JAX package's ``_pnqp_is_exact`` (``riccati.py:418-429``): the masked
    solves outside box mode, and in box mode the m = 1 closed form and the
    enumeration, but not the projected-Newton loop."""
    check_pnqp_enum(mode)
    return not box or m == 1 or pnqp_enumerates(m, mode)


def pnqp_enum_flag(m: int, mode: str) -> int:
    """The kernels' template flag for ``mode`` at ``m`` control dims
    (``PnqpEnum`` in ``csrc/riccati_entries.cuh``): the loop at m = 2 under
    ``"0"``, the enumeration at m = 3 under ``"1"``, and the default
    wherever the mode does not change the QP, so that those share the
    default's kernels."""
    if pnqp_enumerates(m, mode) != pnqp_enumerates(m, ""):
        return ENUM_LOOP if m == 2 else ENUM_THREE
    return ENUM_DEFAULT


def _chol_entries(A, m, reg=0.0):
    """Cholesky of an m x m SPD matrix of entries; lower-factor entries."""
    L = [[None] * m for _ in range(m)]
    for j in range(m):
        s = A[j][j] + reg
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(s)
        L[j][j] = d
        inv = 1.0 / d
        for i in range(j + 1, m):
            s = A[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    return L


def _cho_solve_entries(L, b, m):
    """Solve A x = b given the Cholesky entries L of A; b is a list of m."""
    y = [None] * m
    for i in range(m):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * m
    for i in reversed(range(m)):
        s = y[i]
        for k in range(i + 1, m):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def _masked_chol_solve(Quu, rhs_cols, frozen, m, reg):
    """Solve (masked Quu) X = rhs for several rhs columns, with frozen dims
    replaced by identity rows/cols and their rhs rows zeroed."""
    free = [1.0 - frozen[i] for i in range(m)]
    if m == 1:
        # scalar system: one reciprocal
        inv = 1.0 / (Quu[0][0] * free[0] + frozen[0] + reg)
        return [[col[0] * free[0] * inv] for col in rhs_cols]
    Am = [
        [
            Quu[i][j] * free[i] * free[j] + (frozen[i] if i == j else 0.0)
            for j in range(m)
        ]
        for i in range(m)
    ]
    L = _chol_entries(Am, m, reg)
    return [
        _cho_solve_entries(L, [col[i] * free[i] for i in range(m)], m)
        for col in rhs_cols
    ]


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _qp_obj(Quu, qu, x, m):
    return sum(0.5 * x[i] * sum(Quu[i][j] * x[j] for j in range(m)) + qu[i] * x[i] for i in range(m))


def _qp_frozen(Quu, qu, lo, hi, x, m):
    """The clamped mask at ``x``, with the 1e-6 boundary tolerance of
    ops/pnqp.py, as 1.0 / 0.0 entries."""
    g = [sum(Quu[i][j] * x[j] for j in range(m)) + qu[i] for i in range(m)]
    return [
        (((x[i] <= lo[i] + 1e-6) & (g[i] > 0)) | ((x[i] >= hi[i] - 1e-6) & (g[i] < 0))).to(x[i].dtype)
        for i in range(m)
    ]


def _clipped_newton(Quu, qu, lo, hi, m, reg):
    L0 = _chol_entries(Quu, m, reg)
    x0 = _cho_solve_entries(L0, [-qu[i] for i in range(m)], m)
    return [_clip(x0[i], lo[i], hi[i]) for i in range(m)]


def _pnqp_enum_entries(Quu, qu, lo, hi, m, reg):
    """Exact box QP by active-set enumeration: the ``3**m`` candidates (each
    dim free / at lo / at hi) in ``itertools.product`` order, each solved on
    its free block; the KKT-valid candidate of least objective wins by a
    strict ``<`` (ties go to the earlier candidate), starting from the
    clipped Newton point. Relative tolerances, as on the TPU."""
    tol = 1e-6
    tol_b = [tol * (1.0 + torch.abs(hi[i] - lo[i])) for i in range(m)]
    tol_g = [tol * (1.0 + torch.abs(qu[i])) for i in range(m)]
    big = torch.full_like(qu[0], 1e30)
    best = _clipped_newton(Quu, qu, lo, hi, m, reg)
    best_obj = _qp_obj(Quu, qu, best, m)
    for combo in itertools.product((0, 1, 2), repeat=m):
        free_idx = [i for i, s in enumerate(combo) if s == 0]
        if len(free_idx) == m:
            continue  # all free: the starting candidate
        fixed = {i: (lo[i] if s == 1 else hi[i]) for i, s in enumerate(combo) if s != 0}
        x = [fixed.get(i) for i in range(m)]
        if free_idx:
            A = [[Quu[i][j] for j in free_idx] for i in free_idx]
            b = [-(qu[i] + sum(Quu[i][j] * fixed[j] for j in fixed)) for i in free_idx]
            sol = _cho_solve_entries(_chol_entries(A, len(free_idx), reg), b, len(free_idx))
            for k, i in enumerate(free_idx):
                x[i] = sol[k]
        g = [sum(Quu[i][j] * x[j] for j in range(m)) + qu[i] for i in range(m)]
        valid = None
        for i, s in enumerate(combo):
            if s == 0:
                ok = (x[i] >= lo[i] - tol_b[i]) & (x[i] <= hi[i] + tol_b[i])
            elif s == 1:
                ok = g[i] >= -tol_g[i]
            else:
                ok = g[i] <= tol_g[i]
            valid = ok if valid is None else (valid & ok)
        x = [_clip(x[i], lo[i], hi[i]) for i in range(m)]
        o = torch.where(valid, _qp_obj(Quu, qu, x, m), big)
        take = o < best_obj
        best = [torch.where(take, x[i], best[i]) for i in range(m)]
        best_obj = torch.where(take, o, best_obj)
    return best


def _pnqp_loop_entries(Quu, qu, lo, hi, m, n_iter, reg):
    """Box QP by projected Newton (m >= 3, and m = 2 under the mode ``"0"``):
    ``n_iter`` steps with converged scenarios frozen, each the masked Newton
    direction and a first-improving 6-step Armijo ladder. Returns
    ``(x, n_qp)``, ``n_qp`` the iterations used while active."""
    x = _clipped_newton(Quu, qu, lo, hi, m, reg)
    done = torch.zeros_like(x[0])
    n_qp = torch.zeros_like(x[0])
    for _ in range(n_iter):
        frozen = _qp_frozen(Quu, qu, lo, hi, x, m)
        g = [sum(Quu[i][j] * x[j] for j in range(m)) + qu[i] for i in range(m)]
        (dx,) = _masked_chol_solve(Quu, [[-g[i] for i in range(m)]], frozen, m, reg)
        slack = sum(torch.clamp_min(torch.abs(dx[i]) - 1e-6, 0.0) for i in range(m))
        step_small = (slack == 0.0).to(done.dtype)
        f0 = _qp_obj(Quu, qu, x, m)
        best, accepted, alpha = x, torch.zeros_like(f0), 1.0
        for _a in range(6):
            cand = [_clip(x[i] + alpha * dx[i], lo[i], hi[i]) for i in range(m)]
            better = (_qp_obj(Quu, qu, cand, m) < f0) & (accepted == 0.0)
            best = [torch.where(better, cand[i], best[i]) for i in range(m)]
            accepted = torch.where(better, 1.0, accepted)
            alpha *= 0.5
        x = [torch.where(done > 0, x[i], best[i]) for i in range(m)]
        n_qp = n_qp + (1.0 - done)
        done = torch.maximum(done, torch.maximum(step_small, 1.0 - accepted))
    return x, n_qp


def _pnqp_entries(Quu, qu, lo, hi, m, n_iter, reg, pnqp_enum=""):
    """Box QP ``min 0.5 x'Quu x + qu'x, lo <= x <= hi``: returns
    ``(x, frozen, n_qp)``. Dispatch as the TPU kernel's under
    ``pnqp_enum`` (:func:`pnqp_enumerates`): the enumeration where it
    enumerates, else the exact m = 1 closed form (``n_qp = 1`` for both,
    direct solves) and the projected-Newton loop of ``n_iter`` steps."""
    if pnqp_enumerates(m, pnqp_enum):
        x = _pnqp_enum_entries(Quu, qu, lo, hi, m, reg)
        return x, _qp_frozen(Quu, qu, lo, hi, x, m), torch.ones_like(qu[0])
    if m == 1:
        h = Quu[0][0] + reg
        x = _clip(-qu[0] / h, lo[0], hi[0])
        g = Quu[0][0] * x + qu[0]
        # the same 1e-6 boundary tolerance as ops/pnqp.py
        clamped = ((x <= lo[0] + 1e-6) & (g > 0)) | ((x >= hi[0] - 1e-6) & (g < 0))
        return [x], [clamped.to(x.dtype)], torch.ones_like(x)
    x, n_qp = _pnqp_loop_entries(Quu, qu, lo, hi, m, n_iter, reg)
    return x, _qp_frozen(Quu, qu, lo, hi, x, m), n_qp


def _value_update(Q, q, Quu, qu, K, kt, n, m, exact=False):
    """Value-function update ``(V', v')`` from the gains, full quadratic
    form: ``V' = Qxx + Qxu K + K'Qux + K'Quu K`` and
    ``v' = qx + Qxu k + K'(qu + Quu k)``; with ``exact``, the simplified
    form of the JAX package's ``_value_update(..., exact=True)``
    (``riccati.py:433-458``), ``V' = Qxx + (Qxu K + (Qxu K)')/2`` and
    ``v' = qx + Qxu k``, for gains that are exact masked solves of an exact
    box QP. Returns ``Vn`` as an n x n entry list (upper triangle mirrored)
    and ``vn`` as an n entry list."""
    Vn = [[None] * n for _ in range(n)]
    if exact:
        for a in range(n):
            for b in range(a, n):
                qxuK_ab = sum(Q[a][n + r] * K[r][b] for r in range(m))
                qxuK_ba = sum(Q[b][n + r] * K[r][a] for r in range(m))
                val = Q[a][b] + 0.5 * (qxuK_ab + qxuK_ba)
                Vn[a][b] = val
                Vn[b][a] = val
        return Vn, [q[a] + sum(Q[a][n + r] * kt[r] for r in range(m)) for a in range(n)]
    QuuK = [
        [sum(Quu[a][r] * K[r][j] for r in range(m)) for j in range(n)]
        for a in range(m)
    ]
    Quuk = [sum(Quu[a][r] * kt[r] for r in range(m)) for a in range(m)]
    for a in range(n):
        for b in range(a, n):
            qxuK_ab = sum(Q[a][n + r] * K[r][b] for r in range(m))
            qxuK_ba = sum(Q[b][n + r] * K[r][a] for r in range(m))
            kQk = sum(K[r][a] * QuuK[r][b] for r in range(m))
            val = Q[a][b] + qxuK_ab + qxuK_ba + kQk
            Vn[a][b] = val
            Vn[b][a] = val
    vn = [
        q[a]
        + sum(Q[a][n + r] * kt[r] for r in range(m))
        + sum(K[r][a] * (qu[r] + Quuk[r]) for r in range(m))
        for a in range(n)
    ]
    return Vn, vn
