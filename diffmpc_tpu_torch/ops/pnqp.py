"""Batched box QP in matrix form (counterpart of :mod:`diffmpc_tpu.ops.pnqp`).

Solves ``min_x 0.5 x'Hx + q'x  s.t. lower <= x <= upper`` for a batch of
tiny (m <= ~8) QPs. The Riccati kernel solves the same QP entry by entry
(:mod:`diffmpc_tpu_torch.ops.cuda.riccati_entries`); this module is its
matrix-form reference, with the JAX package's dispatch under each mode of
its ``DIFFMPC_PNQP_ENUM``, here the keyword ``pnqp_enum``
(:func:`~diffmpc_tpu_torch.ops.cuda.riccati_entries.pnqp_enumerates`): the
exact active-set enumeration at m = 2 (unless ``"0"``) and at m = 3 under
``"1"``, the closed form at m = 1, and otherwise the projected-Newton loop (a
fixed trip count with converged elements frozen and a first-improving
Armijo ladder).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional

import torch

from ..utils.batch import bdot, bmv, bquad, eclamp
from .cuda.riccati_entries import pnqp_enumerates
from .smallchol import cho_solve_small, cholesky_small


class PnqpResult(NamedTuple):
    x: torch.Tensor  # (..., m) solution (clamped into the box)
    chol_free: torch.Tensor  # (..., m, m) Cholesky factor of the masked H
    free_mask: torch.Tensor  # (..., m) bool, True where the bound is inactive
    n_iter: torch.Tensor  # (...,) int32, Newton iterations used


def masked_identity_system(H: torch.Tensor, clamped: torch.Tensor, reg: float = 0.0) -> torch.Tensor:
    """Overwrite the clamped rows and columns of ``H`` with identity (plus
    ``reg`` on the diagonal): with the clamped rhs entries zeroed, a dense
    solve of the masked system is the free-subspace solve."""
    m = H.shape[-1]
    free = ~clamped
    keep = (free[..., :, None] & free[..., None, :]).to(H.dtype)
    eye = torch.eye(m, dtype=H.dtype, device=H.device)
    Hm = H * keep + eye * clamped[..., None, :].to(H.dtype)
    if reg:
        Hm = Hm + reg * eye
    return Hm


def _obj(H, q, x):
    return 0.5 * bquad(x, H) + bdot(q, x)


def _clamped_set(x, g, lower, upper, eps):
    return ((x <= lower + eps) & (g > 0)) | ((x >= upper - eps) & (g < 0))


def _pnqp_enum(H, q, lower, upper, reg, eps) -> PnqpResult:
    """Exact box QP by enumerating the ``3**m`` active sets (each dim free,
    at its lower or at its upper bound) in ``itertools.product`` order; the
    KKT-valid candidate of least objective wins, ties going to the first.
    The clipped unconstrained Newton point is the starting candidate. The
    validity tolerances are relative: ``1e-6 (1 + |upper - lower|)`` on the
    bounds and ``1e-6 (1 + |q|)`` on the gradient signs."""
    m = q.shape[-1]
    big = torch.full_like(q[..., 0], 1e30)
    tol = 1e-6
    tol_b = tol * (1.0 + torch.abs(upper - lower))
    tol_g = tol * (1.0 + torch.abs(q))

    x0 = -cho_solve_small(cholesky_small(H, reg), q[..., None])[..., 0]
    best = eclamp(x0, lower, upper)
    best_obj = _obj(H, q, best)
    for combo in itertools.product((0, 1, 2), repeat=m):
        if all(s == 0 for s in combo):
            continue  # all free: the starting candidate
        fixed = torch.tensor([s != 0 for s in combo], device=q.device)
        at_lo = torch.tensor([s == 1 for s in combo], device=q.device)
        at_hi = torch.tensor([s == 2 for s in combo], device=q.device)
        xf = torch.where(at_lo, lower, torch.where(at_hi, upper, torch.zeros_like(q)))
        Hm = masked_identity_system(H, fixed.expand(q.shape), reg)
        rhs = torch.where(fixed, torch.zeros_like(q), -(q + bmv(H, xf)))
        x = xf + cho_solve_small(cholesky_small(Hm), rhs[..., None])[..., 0]
        g = bmv(H, x) + q
        ok = torch.stack(
            [(x >= lower - tol_b) & (x <= upper + tol_b), g >= -tol_g, g <= tol_g], -1
        )
        sel = torch.tensor(combo, device=q.device).expand(q.shape)
        valid = torch.gather(ok, -1, sel[..., None])[..., 0].all(-1)
        x = eclamp(x, lower, upper)
        o = torch.where(valid, _obj(H, q, x), big)
        take = o < best_obj
        best = torch.where(take[..., None], x, best)
        best_obj = torch.where(take, o, best_obj)

    Ic = _clamped_set(best, bmv(H, best) + q, lower, upper, eps)
    return PnqpResult(
        best,
        cholesky_small(masked_identity_system(H, Ic, reg)),
        ~Ic,
        torch.ones(q.shape[:-1], dtype=torch.int32, device=q.device),
    )


def pnqp(
    H: torch.Tensor,
    q: torch.Tensor,
    lower,
    upper,
    x_init: Optional[torch.Tensor] = None,
    n_iter: int = 20,
    reg: float = 1e-9,
    eps: float = 1e-6,
    armijo_decay: float = 0.5,
    armijo_iter: int = 8,
    pnqp_enum: str = "",
) -> PnqpResult:
    """Solve a batch of box QPs: ``H (..., m, m)`` SPD, ``q (..., m)``,
    bounds broadcastable to ``q``, under the enumeration mode ``pnqp_enum``.
    Returns the solution, the Cholesky factor of the final masked system,
    the free mask and the iteration count (1 for the direct solves: the
    enumeration and the m = 1 closed form)."""
    m = H.shape[-1]
    lower = torch.as_tensor(lower, dtype=H.dtype, device=H.device).expand(q.shape)
    upper = torch.as_tensor(upper, dtype=H.dtype, device=H.device).expand(q.shape)
    if pnqp_enumerates(m, pnqp_enum):
        return _pnqp_enum(H, q, lower, upper, reg, eps)
    if m == 1:
        h = H[..., 0, 0] + reg
        x = eclamp(-q[..., 0] / h, lower[..., 0], upper[..., 0])[..., None]
        Ic = _clamped_set(x, bmv(H, x) + q, lower, upper, eps)
        Hm = torch.where(Ic[..., None], torch.ones_like(H), H + reg)
        ones = torch.ones(q.shape[:-1], dtype=torch.int32, device=q.device)
        return PnqpResult(x, torch.sqrt(Hm), ~Ic, ones)

    if x_init is None:
        x_init = -cho_solve_small(cholesky_small(H, reg), q[..., None])[..., 0]
    x = eclamp(x_init, lower, upper)
    alphas = armijo_decay ** torch.arange(armijo_iter, dtype=H.dtype, device=H.device)
    done = torch.zeros(q.shape[:-1], dtype=torch.bool, device=q.device)
    iters = torch.zeros(q.shape[:-1], dtype=torch.int32, device=q.device)
    for _ in range(n_iter):
        g = bmv(H, x) + q
        Ic = _clamped_set(x, g, lower, upper, eps)
        gm = torch.where(Ic, torch.zeros_like(g), g)
        dx = -cho_solve_small(cholesky_small(masked_identity_system(H, Ic, reg)), gm[..., None])[..., 0]
        step_small = dx.abs().amax(-1) < eps
        cand = eclamp(
            x[..., None, :] + alphas[:, None] * dx[..., None, :], lower[..., None, :], upper[..., None, :]
        )  # (..., A, m)
        objs = _obj(H[..., None, :, :], q[..., None, :], cand)
        improved = objs < _obj(H, q, x)[..., None]
        any_improved = improved.any(-1)
        first = torch.argmax(improved.to(torch.int8), -1)
        x_new = torch.gather(cand, -2, first[..., None, None].expand(*first.shape, 1, m))[..., 0, :]
        x_new = torch.where(any_improved[..., None], x_new, x)
        x = torch.where(done[..., None], x, x_new)
        iters = iters + (~done).to(torch.int32)
        done = done | step_small | ~any_improved

    Ic = _clamped_set(x, bmv(H, x) + q, lower, upper, eps)
    return PnqpResult(x, cholesky_small(masked_identity_system(H, Ic, reg)), ~Ic, iters)
