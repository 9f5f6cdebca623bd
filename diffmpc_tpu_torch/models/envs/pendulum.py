"""Differentiable swing-up pendulum (counterpart of
:class:`diffmpc_tpu.models.envs.pendulum.PendulumDx`).

State ``(cos th, sin th, thdot)``, torque control clamped to
``+-max_torque``, learnable physical params ``(g, m, l)``, semi-implicit
Euler step with ``dt = 0.05`` and ``thdot`` clamped to ``+-max_speed``.
:meth:`PendulumDx.entries_step` is the step the fused solve linearizes; the
CUDA kernel's ``PendulumEnv::step`` (``csrc/pendulum.cuh``) is a line-for-line
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
class PendulumDx(Dynamics):
    params: torch.Tensor  # (3,) = (g, m, l), or per-scenario (B, 3)
    max_torque: float = 2.0
    max_speed: float = 8.0
    dt: float = 0.05
    # If True the torque is clamped inside the dynamics; MPC box bounds make
    # this redundant, but standalone rollouts rely on it.
    clamp_ctrl: bool = True
    n_state: int = 3
    n_ctrl: int = 1

    @staticmethod
    def default(dtype=torch.float32, device="cuda") -> "PendulumDx":
        """The swing-up pendulum with ``(g, m, l) = (10, 1, 1)``, on the card
        unless ``device`` says otherwise (without a card that raises)."""
        return PendulumDx(params=torch.tensor([10.0, 1.0, 1.0], dtype=dtype, device=device))

    def forward(self, x, u):
        # trailing-axis indexing so per-scenario (B, 3) params broadcast
        # against (..., B) state entries
        g, m, l = self.params[..., 0], self.params[..., 1], self.params[..., 2]
        cos_th, sin_th, thdot = x[..., 0], x[..., 1], x[..., 2]
        uu = u[..., 0]
        if self.clamp_ctrl:
            uu = bclamp(uu, -self.max_torque, self.max_torque)
        th = torch.atan2(sin_th, cos_th)
        # sin(th + pi) = -sin(th)
        newthdot = thdot + self.dt * (
            3.0 * g / (2.0 * l) * sin_th + 3.0 * uu / (m * l * l)
        )
        newthdot = bclamp(newthdot, -self.max_speed, self.max_speed)
        newth = th + self.dt * newthdot
        return torch.stack([torch.cos(newth), torch.sin(newth), newthdot], dim=-1)

    def entries_step(self, params, x_entries, u_entries):
        """Entry-wise step for the fused solve: each entry is a ``(B,)``
        tensor and ``params`` a list of scalars or ``(B,)`` rows. Equal to
        :meth:`forward` in exact arithmetic, with the angle update written
        through the rotation identity instead of ``atan2``."""
        g, m, l = params[0], params[1], params[2]
        cos_th, sin_th, thdot = x_entries
        uu = u_entries[0]
        if self.clamp_ctrl:
            uu = bclamp(uu, -self.max_torque, self.max_torque)
        newthdot = thdot + self.dt * (
            3.0 * g / (2.0 * l) * sin_th + 3.0 * uu / (m * l * l)
        )
        newthdot = bclamp(newthdot, -self.max_speed, self.max_speed)
        inv_r = torch.rsqrt(cos_th * cos_th + sin_th * sin_th)
        c_hat, s_hat = cos_th * inv_r, sin_th * inv_r
        d = self.dt * newthdot
        cd, sd = torch.cos(d), torch.sin(d)
        return [c_hat * cd - s_hat * sd, s_hat * cd + c_hat * sd, newthdot]

    def grad_input(self, x, u):
        """Closed-form Jacobians ``(A (..., 3, 3), B (..., 3, 1))`` of
        :meth:`forward`. Saturations zero the relevant rows with STRICT
        inequalities, matching autodiff through the boundary-strict
        ``bclamp``: the derivative is 1 at exactly the bound."""
        g, m, l = self.params[..., 0], self.params[..., 1], self.params[..., 2]
        cos_th, sin_th, thdot = x[..., 0], x[..., 1], x[..., 2]
        uu = u[..., 0]
        dt = self.dt

        if self.clamp_ctrl:
            u_sat = (uu < -self.max_torque) | (uu > self.max_torque)
        else:
            u_sat = torch.zeros_like(uu, dtype=torch.bool)
        du = torch.where(u_sat, 0.0, 1.0).to(uu.dtype)

        r2 = cos_th * cos_th + sin_th * sin_th
        dth_dcos = -sin_th / r2
        dth_dsin = cos_th / r2

        a_sin = dt * 1.5 * g / l
        b_u = dt * 3.0 / (m * l * l)
        if self.clamp_ctrl:
            ntd_pre = thdot + a_sin * sin_th + b_u * torch.clamp(
                uu, -self.max_torque, self.max_torque
            )
        else:
            ntd_pre = thdot + a_sin * sin_th + b_u * uu
        sat = (ntd_pre < -self.max_speed) | (ntd_pre > self.max_speed)
        dsat = torch.where(sat, 0.0, 1.0).to(uu.dtype)

        d_ntd_dcos = torch.zeros_like(cos_th)
        d_ntd_dsin = dsat * a_sin
        d_ntd_dthdot = dsat * 1.0
        d_ntd_du = dsat * b_u * du

        d_nth_dcos = dth_dcos + dt * d_ntd_dcos
        d_nth_dsin = dth_dsin + dt * d_ntd_dsin
        d_nth_dthdot = dt * d_ntd_dthdot
        d_nth_du = dt * d_ntd_du

        ntd = torch.clamp(ntd_pre, -self.max_speed, self.max_speed)
        th = torch.atan2(sin_th, cos_th)
        nth = th + dt * ntd
        c_n, s_n = torch.cos(nth), torch.sin(nth)

        A = torch.stack(
            [
                torch.stack([-s_n * d_nth_dcos, -s_n * d_nth_dsin, -s_n * d_nth_dthdot], -1),
                torch.stack([c_n * d_nth_dcos, c_n * d_nth_dsin, c_n * d_nth_dthdot], -1),
                torch.stack([d_ntd_dcos, d_ntd_dsin, d_ntd_dthdot], -1),
            ],
            dim=-2,
        )
        B = torch.stack([-s_n * d_nth_du, c_n * d_nth_du, d_ntd_du], -1)[..., None]
        return A, B

    def get_true_obj(self, dtype=None):
        """Goal-state quadratic cost ingredients ``(q, p)``: ``C = diag(q)``,
        ``c = p``, minimized at the upright goal."""
        dtype = dtype or self.params.dtype
        kw = dict(dtype=dtype, device=self.params.device)
        goal_weights = torch.tensor([1.0, 1.0, 0.1], **kw)
        goal_state = torch.tensor([1.0, 0.0, 0.0], **kw)
        ctrl_penalty = 0.001
        q = torch.cat([goal_weights, ctrl_penalty * torch.ones(self.n_ctrl, **kw)])
        p = torch.cat([-goal_weights * goal_state, torch.zeros(self.n_ctrl, **kw)])
        return q, p

    def angle_from_state(self, x):
        """The pole's angle from upright, ``atan2(sin th, cos th)``."""
        return torch.atan2(x[..., 1], x[..., 0])

    def get_frame(self, x, ax=None):
        """Render one matplotlib frame: the rod from the pivot. ``x`` is a
        tensor on any device or an array; host-side, requires matplotlib."""
        import matplotlib.pyplot as plt

        x, params = frame_inputs(self, x)
        th = float(np.arctan2(x[1], x[0]))
        l = float(params[2])
        if ax is None:
            _, ax = plt.subplots(figsize=(4, 4))
        ax.plot([0.0, l * np.sin(th)], [0.0, l * np.cos(th)], color="k", lw=3)
        ax.set_xlim(-1.2 * l, 1.2 * l)
        ax.set_ylim(-1.2 * l, 1.2 * l)
        return ax
