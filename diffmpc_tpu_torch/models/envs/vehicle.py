"""Differentiable kinematic-bicycle vehicle, lane keeping (counterpart of
:class:`diffmpc_tpu.models.envs.vehicle.VehicleDx`).

State ``(px, py, psi, v)``, controls ``(a, delta)`` on an asymmetric box
(acceleration in ``[-max_brake, max_accel]``, steering ``|delta| <=
max_steer``), learnable params ``(wheelbase L, drag c_d)``; a semi-implicit
Euler step

    v'   = clamp(v + dt (a - c_d v), 0, v_max)
    psi' = psi + dt * v' tan(delta) / L
    px'  = px + dt * v' cos(psi')
    py'  = py + dt * v' sin(psi')

with ``tan`` written ``sin / cos``. :meth:`VehicleDx._step` is the one copy
of the kinematics, shared by :meth:`forward` and :meth:`entries_step`; the
CUDA kernels' ``VehicleEnv::step`` (``csrc/vehicle.cuh``) is a line-for-line
copy of it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...utils.batch import bclamp
from ..dynamics import Dynamics
from .frame import frame_inputs


@dataclasses.dataclass(frozen=True, eq=False)
class VehicleDx(Dynamics):
    params: torch.Tensor  # (2,) = (wheelbase L, drag c_d), or per-scenario (B, 2)
    max_accel: float = 3.0
    max_brake: float = 6.0
    max_steer: float = 0.5
    max_speed: float = 15.0
    v_ref: float = 5.0
    dt: float = 0.05
    clamp_ctrl: bool = True
    n_state: int = 4
    n_ctrl: int = 2

    @staticmethod
    def default(dtype=torch.float32, device="cuda") -> "VehicleDx":
        """The vehicle with ``(L, c_d) = (2.7, 0.1)``, on the card unless
        ``device`` says otherwise (without a card that raises)."""
        return VehicleDx(params=torch.tensor([2.7, 0.1], dtype=dtype, device=device))

    def _split_params(self):
        # trailing-axis indexing so per-scenario (B, 2) params broadcast
        # against (..., B) state entries
        return self.params[..., 0], self.params[..., 1]

    def _step(self, L, c_d, px, py, psi, v, a, delta):
        """One semi-implicit Euler step on entries: the single copy of the
        kinematics that :meth:`forward` and :meth:`entries_step` share."""
        if self.clamp_ctrl:
            a = bclamp(a, -self.max_brake, self.max_accel)
            delta = bclamp(delta, -self.max_steer, self.max_steer)
        nv = bclamp(v + self.dt * (a - c_d * v), 0.0, self.max_speed)
        # tan via sin / cos: pole-free for |delta| <= 0.5
        tan_d = torch.sin(delta) / torch.cos(delta)
        npsi = psi + self.dt * nv * tan_d / L
        npx = px + self.dt * nv * torch.cos(npsi)
        npy = py + self.dt * nv * torch.sin(npsi)
        return npx, npy, npsi, nv

    def forward(self, x, u):
        L, c_d = self._split_params()
        px, py, psi, v = (x[..., i] for i in range(4))
        return torch.stack(self._step(L, c_d, px, py, psi, v, u[..., 0], u[..., 1]), dim=-1)

    def entries_step(self, params, x_entries, u_entries):
        """Entry-wise step for the fused solve (each entry a ``(B,)`` tensor,
        ``params`` a list of scalars or ``(B,)`` rows): :meth:`_step`."""
        L, c_d = params
        px, py, psi, v = x_entries
        a, delta = u_entries
        return list(self._step(L, c_d, px, py, psi, v, a, delta))

    # grad_input: the protocol's exact forward-mode autodiff of forward

    def coast_accel(self):
        """The acceleration that holds ``v_ref`` against drag."""
        _, c_d = self._split_params()
        return c_d * self.v_ref

    def get_true_obj(self, dtype=None):
        """Lane-keeping cost ingredients ``(q, p)``: lateral offset, heading
        and speed error toward ``(0, 0, v_ref)`` (progress ``px`` free), the
        control penalties centred at ``(coast_accel, 0)``."""
        if self.param_batch_shape:
            raise ValueError(
                "get_true_obj uses shared params; per-scenario costs go "
                "through the (T, B, ...) QuadCost contract directly"
            )
        dtype = dtype or self.params.dtype
        kw = dict(dtype=dtype, device=self.params.device)
        goal_weights = torch.tensor([0.0, 1.0, 2.0, 0.5], **kw)
        goal_state = torch.tensor([0.0, 0.0, 0.0, self.v_ref], **kw)
        ctrl_penalty = torch.tensor([0.1, 0.5], **kw)
        a_ref = self.coast_accel().to(dtype)
        q = torch.cat([goal_weights, ctrl_penalty])
        p = torch.cat([-goal_weights * goal_state, torch.stack([-ctrl_penalty[0] * a_ref, torch.zeros((), **kw)])])
        return q, p

    def get_frame(self, x, ax=None):
        """Render one matplotlib frame: the car as an oriented wheelbase
        segment on the lane (y = 0 dashed). ``x`` is a tensor on any device
        or an array; host-side, requires matplotlib."""
        import matplotlib.pyplot as plt

        x, params = frame_inputs(self, x)
        px, py, psi = float(x[0]), float(x[1]), float(x[2])
        L = float(params[0])
        if ax is None:
            _, ax = plt.subplots(figsize=(6, 3))
        ax.axhline(0.0, color="0.7", ls="--", lw=1)
        fx, fy = px + L * np.cos(psi), py + L * np.sin(psi)
        ax.plot([px, fx], [py, fy], color="k", lw=3)
        ax.plot([px], [py], marker="s", color="b")
        ax.set_xlim(px - 2 * L, px + 2 * L)
        ax.set_ylim(-2.5, 2.5)
        return ax
