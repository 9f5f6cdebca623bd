"""Batched small-matrix helpers (counterpart of :mod:`diffmpc_tpu.utils.batch`).

All functions broadcast over leading batch dimensions. The contractions are
written as elementwise products and sums, never as matrix products, so no
TF32 setting can lower their precision on the card.
"""

from __future__ import annotations

from typing import Optional

import torch


def bmv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product: ``(..., i, j), (..., j) -> (..., i)``."""
    return (m * v[..., None, :]).sum(-1)


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched matrix product: ``(..., i, j), (..., j, k) -> (..., i, k)``."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def bdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched inner product over the trailing dim."""
    return (x * y).sum(-1)


def bger(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched outer product: ``(..., i), (..., j) -> (..., i, j)``."""
    return x[..., :, None] * y[..., None, :]


def bdiag(d: torch.Tensor) -> torch.Tensor:
    """Batched vector -> diagonal matrix: ``(..., i) -> (..., i, i)``."""
    return d[..., None, :] * torch.eye(d.shape[-1], dtype=d.dtype, device=d.device)


def btrans(m: torch.Tensor) -> torch.Tensor:
    """Batched matrix transpose over the two trailing dims."""
    return m.transpose(-1, -2)


def bquad(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Batched quadratic form ``x' M x``: ``(..., i), (..., i, i) -> (...)``."""
    return bdot(x, bmv(m, x))


def symmetrize(m: torch.Tensor) -> torch.Tensor:
    """``0.5 (M + M')`` over the two trailing dims."""
    return 0.5 * (m + btrans(m))


def eclamp(
    x: torch.Tensor,
    lower: Optional[torch.Tensor],
    upper: Optional[torch.Tensor],
) -> torch.Tensor:
    """Elementwise clamp with possibly absent bounds, in the reference's
    max/min form (``None`` leaves that side unconstrained). Bounds may be
    scalars or tensors that broadcast against ``x``."""
    if lower is not None:
        x = torch.maximum(x, torch.as_tensor(lower, dtype=x.dtype, device=x.device))
    if upper is not None:
        x = torch.minimum(x, torch.as_tensor(upper, dtype=x.dtype, device=x.device))
    return x


def bclamp(x: torch.Tensor, lower, upper) -> torch.Tensor:
    """Boundary-strict clamp for env dynamics: the values of a clip, with
    derivative 1 at exactly the bound. ``torch.minimum`` / ``torch.maximum``
    give 0.5 there, and box-DDP puts saturated controls exactly on the
    bound, so a halved control Jacobian would blind the solver."""
    return torch.where(x < lower, lower, torch.where(x > upper, upper, x))


def detach(x: torch.Tensor) -> torch.Tensor:
    """Cut gradients through a tensor (the reference's ``.detach()``)."""
    return x.detach()
