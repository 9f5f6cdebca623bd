"""Core problem types of the PyTorch port.

Counterpart of :mod:`diffmpc_tpu.types` with the same knob names and
defaults. Costs are plain ``NamedTuple``s of tensors and the solver knobs
live in a frozen dataclass.

Canonical shape contract, with horizon ``T``, batch ``B``, state dim ``n``,
control dim ``m`` and tau_t = [x_t; u_t] in R^{n+m}:

- ``QuadCost.C``: ``(T, B, n+m, n+m)`` (PSD per slice), ``QuadCost.c``:
  ``(T, B, n+m)``; ``mpc_solve`` also accepts the untimed / unbatched
  variants and expands them.
- ``LinDx.F``: ``(T, B, n, n+m)``, ``LinDx.f``: ``(T, B, n)`` or ``None``
  (zeros); semantics ``x_{t+1} = F_t tau_t + f_t`` (the ``t = T-1`` slice is
  unused). ``mpc_solve`` also accepts the untimed / unbatched variants.
- ``x_init``: ``(B, n)``; the solve returns ``x*: (T, B, n)``,
  ``u*: (T, B, m)``, ``objs: (B,)``.

The solve follows ``x_init.dtype`` and ``x_init.device``: there is no dtype
knob.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple, Optional

import torch


class QuadCost(NamedTuple):
    """Time-varying quadratic cost 0.5 * tau' C tau + c' tau."""

    C: torch.Tensor
    c: torch.Tensor


class LinDx(NamedTuple):
    """Time-varying affine dynamics ``x_{t+1} = F_t tau_t + f_t``."""

    F: torch.Tensor
    f: Optional[torch.Tensor] = None


class GradMethods(enum.Enum):
    """How to linearize nonlinear dynamics inside the iLQR loop (same values
    as :class:`diffmpc_tpu.types.GradMethods`). The fused solve linearizes
    the env's ``entries_step`` by forward-mode differentiation whatever the
    method, except ``FINITE_DIFF``, which sends the solve to the non-fused
    path (central differences of ``forward``)."""

    AUTO_DIFF = "auto_diff"
    ANALYTIC = "analytic"
    FINITE_DIFF = "finite_diff"
    ANALYTIC_CHECK = "analytic_check"


@dataclasses.dataclass(frozen=True)
class LineSearchConfig:
    """Alpha-ladder line search: ``decay**k, k < max_iter``, first improving
    step per scenario."""

    decay: float = 0.2
    max_iter: int = 10


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Static solver configuration (the reference's ``MPC.__init__`` knobs)."""

    n_state: int
    n_ctrl: int
    T: int
    lqr_iter: int = 10
    grad_method: GradMethods = GradMethods.ANALYTIC
    delta_u: Optional[float] = None
    verbose: int = 0
    eps: float = 1e-7
    back_eps: float = 1e-7
    linesearch_decay: float = 0.2
    max_linesearch_iter: int = 10
    exit_unconverged: bool = True
    detach_unconverged: bool = True
    backprop: bool = True
    not_improved_lim: int = 5
    best_cost_eps: float = 1e-4
    slew_rate_penalty: Optional[float] = None
    # Inner box QP iterations of the projected-Newton loop (m >= 3; the
    # fused path caps it at 8). The m = 1 closed form and the m = 2
    # enumeration do not iterate.
    pnqp_iter: int = 20
    # Tolerance used to detect tight (active) box constraints.
    tight_eps: float = 1e-6
    # None: the CUDA kernel for CUDA tensors, its plain PyTorch version for
    # CPU tensors. True demands the kernel and False the plain version; a
    # demand that does not fit the tensors' device raises.
    use_cuda: Optional[bool] = None
    # The fused solve's linearization pre-pass (ilqr_solve_fused's
    # hoist_lin; the JAX package's env knob DIFFMPC_HOIST_LIN=1): every
    # step's Jacobian before each Riccati sweep, off the value carry's
    # chain. The same solve; a question of speed only.
    hoist_lin: bool = False
    # The box QP's enumeration mode on every path (the JAX package's env
    # knob DIFFMPC_PNQP_ENUM): "" enumerates the active sets at m = 2; "0"
    # takes the projected-Newton loop at m = 2 as well; "1" enumerates the
    # 27 active sets at m = 3 too, where "" and "0" loop.
    pnqp_enum: str = ""
    # The simplified value update (the JAX package's module global
    # VALUE_UPDATE_EXACT_REG): at or above back_eps, every Riccati sweep
    # whose inner solve is exact (the masked solves, the closed form, the
    # enumeration) drops the terms that cancel there; -1 keeps the full form.
    value_update_exact_reg: float = -1.0

    def __post_init__(self):
        if self.pnqp_enum not in ("", "0", "1"):
            raise ValueError(f"pnqp_enum must be one of '', '0', '1'; got {self.pnqp_enum!r}")

    @property
    def n_tau(self) -> int:
        return self.n_state + self.n_ctrl

    @property
    def linesearch(self) -> LineSearchConfig:
        return LineSearchConfig(self.linesearch_decay, self.max_linesearch_iter)
