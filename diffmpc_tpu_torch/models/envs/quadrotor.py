"""Differentiable planar quadrotor, hover stabilisation (counterpart of
:class:`diffmpc_tpu.models.envs.quadrotor.QuadrotorDx`).

State ``(px, pz, phi, vx, vz, om)``, controls ``(u1, u2)`` the rotor
thrusts on the box ``[0, max_thrust]``, learnable params
``(g, mass, arm, inertia)``; a semi-implicit Euler step

    vx'  = vx + dt * (-(u1+u2) sin(phi) / mass)
    vz'  = vz + dt * ( (u1+u2) cos(phi) / mass - g)
    om'  = om + dt * arm * (u2 - u1) / inertia
    px'  = px + dt * vx';  pz' = pz + dt * vz';  phi' = phi + dt * om'

:meth:`QuadrotorDx.entries_step` is the step the fused solve linearizes; the
CUDA kernels' ``QuadrotorEnv::step`` (``csrc/quadrotor.cuh``) is a
line-for-line copy of it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...utils.batch import bclamp
from ..dynamics import Dynamics
from .frame import frame_inputs


@dataclasses.dataclass(frozen=True, eq=False)
class QuadrotorDx(Dynamics):
    params: torch.Tensor  # (4,) = (g, mass, arm, inertia), or per-scenario (B, 4)
    max_thrust: float = 5.0
    dt: float = 0.05
    # clamp the thrusts inside the dynamics, so that standalone rollouts
    # respect the actuators; MPC box bounds make it redundant in a solve
    clamp_ctrl: bool = True
    n_state: int = 6
    n_ctrl: int = 2

    @staticmethod
    def default(dtype=torch.float32, device="cuda") -> "QuadrotorDx":
        """The quadrotor with ``(g, mass, arm, inertia) = (9.81, 0.5, 0.25,
        0.01)``, on the card unless ``device`` says otherwise (without a card
        that raises)."""
        return QuadrotorDx(params=torch.tensor([9.81, 0.5, 0.25, 0.01], dtype=dtype, device=device))

    def _split_params(self):
        # trailing-axis indexing so per-scenario (B, 4) params broadcast
        # against (..., B) state entries
        return tuple(self.params[..., i] for i in range(4))

    def hover_thrust(self):
        """The per-rotor thrust that cancels gravity."""
        g, mass, _, _ = self._split_params()
        return g * mass / 2.0

    def forward(self, x, u):
        g, mass, arm, inertia = self._split_params()
        px, pz, phi, vx, vz, om = (x[..., i] for i in range(6))
        u1, u2 = u[..., 0], u[..., 1]
        if self.clamp_ctrl:
            u1 = bclamp(u1, 0.0, self.max_thrust)
            u2 = bclamp(u2, 0.0, self.max_thrust)
        thrust = u1 + u2
        s, c = torch.sin(phi), torch.cos(phi)
        nvx = vx + self.dt * (-thrust * s / mass)
        nvz = vz + self.dt * (thrust * c / mass - g)
        nom = om + self.dt * (arm * (u2 - u1) / inertia)
        return torch.stack(
            [px + self.dt * nvx, pz + self.dt * nvz, phi + self.dt * nom, nvx, nvz, nom], dim=-1
        )

    def entries_step(self, params, x_entries, u_entries):
        """Entry-wise step for the fused solve (each entry a ``(B,)`` tensor,
        ``params`` a list of scalars or ``(B,)`` rows): :meth:`forward`'s
        arithmetic."""
        g, mass, arm, inertia = params
        px, pz, phi, vx, vz, om = x_entries
        u1, u2 = u_entries
        if self.clamp_ctrl:
            u1 = bclamp(u1, 0.0, self.max_thrust)
            u2 = bclamp(u2, 0.0, self.max_thrust)
        thrust = u1 + u2
        s, c = torch.sin(phi), torch.cos(phi)
        nvx = vx + self.dt * (-thrust * s / mass)
        nvz = vz + self.dt * (thrust * c / mass - g)
        nom = om + self.dt * (arm * (u2 - u1) / inertia)
        return [px + self.dt * nvx, pz + self.dt * nvz, phi + self.dt * nom, nvx, nvz, nom]

    # grad_input: the protocol's exact forward-mode autodiff of forward

    def get_true_obj(self, dtype=None):
        """Hover cost ingredients ``(q, p)``: weights toward the zero state
        and a control penalty centred at the hover thrust (the linear term
        ``-w_u u_hover``)."""
        if self.param_batch_shape:
            raise ValueError(
                "get_true_obj uses shared params; per-scenario costs go "
                "through the (T, B, ...) QuadCost contract directly"
            )
        dtype = dtype or self.params.dtype
        kw = dict(dtype=dtype, device=self.params.device)
        goal_weights = torch.tensor([1.0, 1.0, 1.0, 0.1, 0.1, 0.1], **kw)
        ctrl_penalty = 0.01
        u_hover = self.hover_thrust().to(dtype)
        q = torch.cat([goal_weights, ctrl_penalty * torch.ones(self.n_ctrl, **kw)])
        p = torch.cat([torch.zeros(self.n_state, **kw), (-ctrl_penalty * u_hover).expand(self.n_ctrl)])
        return q, p

    def get_frame(self, x, ax=None):
        """Render one matplotlib frame: body segment + rotor ticks. ``x`` is a
        tensor on any device or an array; host-side, requires matplotlib."""
        import matplotlib.pyplot as plt

        x, params = frame_inputs(self, x)
        px, pz, phi = float(x[0]), float(x[1]), float(x[2])
        arm = float(params[2])
        if ax is None:
            _, ax = plt.subplots(figsize=(4, 4))
        dx_, dz_ = arm * np.cos(phi), arm * np.sin(phi)
        ax.plot([px - dx_, px + dx_], [pz - dz_, pz + dz_], color="k", lw=3)
        for sgn in (-1, 1):
            rx, rz = px + sgn * dx_, pz + sgn * dz_
            ax.plot([rx, rx - 0.3 * arm * np.sin(phi)], [rz, rz + 0.3 * arm * np.cos(phi)], color="b", lw=2)
        lim = max(1.5, abs(px) + 1, abs(pz) + 1)
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        return ax
