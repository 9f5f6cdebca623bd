"""Receding-horizon control (counterpart of :mod:`diffmpc_tpu.receding`).

The deployment pattern: at every environment step, solve the T-step MPC
problem from the current state, apply only the first control, and
warm-start the next solve with the solution shifted one step (the last slot
repeated); the applied control anchors the next solve's slew-rate penalty
(``prev_ctrl``). The episode is a Python loop over warm-started
:func:`~diffmpc_tpu_torch.mpc.mpc_solve` calls, on the card for CUDA
tensors: the loop adds no read of the card on the host beyond those that
``mpc_solve`` makes.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .mpc import MPCSolution, mpc_solve
from .types import MPCConfig


class RecedingState(NamedTuple):
    x: torch.Tensor  # (B, n) the environment's current state
    u_warm: torch.Tensor  # (T, B, m) the next solve's warm start
    prev_u: torch.Tensor  # (B, m) the last applied control (the slew penalty's anchor)


def receding_init(config: MPCConfig, x0: torch.Tensor) -> RecedingState:
    """The state before the first step: ``x0 (B, n)``, a zero warm start and
    a zero last control."""
    T, m, B = config.T, config.n_ctrl, x0.shape[0]
    kw = dict(dtype=x0.dtype, device=x0.device)
    return RecedingState(x=x0, u_warm=torch.zeros((T, B, m), **kw), prev_u=torch.zeros((B, m), **kw))


def receding_step(
    config: MPCConfig,
    state: RecedingState,
    cost,
    dx,
    env_step: Optional[Callable] = None,
    u_lower=None,
    u_upper=None,
) -> tuple[RecedingState, tuple[torch.Tensor, MPCSolution]]:
    """One receding-horizon step: solve from ``state.x`` warm-started with
    ``state.u_warm`` (``prev_ctrl = state.prev_u``), apply the first control
    through ``env_step(x, u)`` (the model ``dx`` itself by default: a
    model-predictive rollout), and shift the solution one step for the next
    warm start, its last slot repeated. Returns ``(new_state, (u_applied,
    solution))``."""
    sol = mpc_solve(
        config, state.x, cost, dx, u_init=state.u_warm, u_lower=u_lower, u_upper=u_upper, prev_ctrl=state.prev_u,
    )
    u0 = sol.us[0]
    stepper = env_step if env_step is not None else dx.forward
    x_next = stepper(state.x, u0)
    u_warm = torch.cat([sol.us[1:], sol.us[-1:]], 0)
    return RecedingState(x=x_next, u_warm=u_warm, prev_u=u0), (u0, sol)


def run_receding_horizon(
    config: MPCConfig,
    x0: torch.Tensor,
    cost,
    dx,
    n_steps: int,
    env_step: Optional[Callable] = None,
    u_lower=None,
    u_upper=None,
):
    """Run the controller for ``n_steps`` environment steps from ``x0``.
    Returns ``(states (n_steps+1, B, n), controls (n_steps, B, m), objs
    (n_steps, B))``: the states visited, the first one included, the
    controls applied and each solve's objective."""
    state = receding_init(config, x0)
    xs, us, objs = [], [], []
    for _ in range(n_steps):
        xs.append(state.x)
        state, (u0, sol) = receding_step(config, state, cost, dx, env_step, u_lower, u_upper)
        us.append(u0)
        objs.append(sol.objs)
    xs.append(state.x)
    return torch.stack(xs), torch.stack(us), torch.stack(objs)
