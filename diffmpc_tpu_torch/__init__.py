"""PyTorch + CUDA port of the differentiable-MPC engine.

A second package beside :mod:`diffmpc_tpu` (the JAX reference, which it is
tested against). It imports ``torch`` and never ``jax``. The fused
box-constrained iLQR solve, the non-fused path's Riccati sweep and
line-search rollout, and the analytic KKT backward of the gradient run as
hand-written CUDA kernels on CUDA tensors and as their plain PyTorch
versions on CPU tensors.
"""

from .mpc import MPC, MPCInfo, MPCSolution, mpc_solve
from .receding import RecedingState, receding_init, receding_step, run_receding_horizon
from .types import GradMethods, LinDx, LineSearchConfig, MPCConfig, QuadCost

__all__ = [
    "MPC",
    "MPCConfig",
    "MPCInfo",
    "MPCSolution",
    "GradMethods",
    "LinDx",
    "LineSearchConfig",
    "QuadCost",
    "RecedingState",
    "mpc_solve",
    "receding_init",
    "receding_step",
    "run_receding_horizon",
]
