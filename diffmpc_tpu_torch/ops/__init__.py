"""Solver operations of the PyTorch port."""

from .lqr import LineSearchResult, RiccatiResult, lqr_linesearch_rollout, lqr_rollout, riccati_backward, trajectory_cost
from .pnqp import PnqpResult, masked_identity_system, pnqp

__all__ = [
    "LineSearchResult",
    "PnqpResult",
    "RiccatiResult",
    "lqr_linesearch_rollout",
    "lqr_rollout",
    "masked_identity_system",
    "pnqp",
    "riccati_backward",
    "trajectory_cost",
]
