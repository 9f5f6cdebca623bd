"""Differentiable acrobot, an underactuated double pendulum (counterpart of
:class:`diffmpc_tpu.models.envs.acrobot.AcrobotDx`).

State ``(cos th1, sin th1, cos th2, sin th2, om1, om2)`` with ``th1``
measured from upright and ``th2`` the relative elbow angle; one control, the
elbow torque, clamped to ``+-max_torque``; learnable params
``(m1, m2, l1, l2)`` (uniform rods, ``g = 9.8`` fixed). The step solves the
2x2 system ``M(q) qdd = rhs`` in closed form, clamps both speeds and takes a
semi-implicit Euler step at ``dt = 0.01`` (the upright is ~7 rad/s
unstable: 20 Hz is too slow to balance it). :meth:`AcrobotDx._accelerations`
is the one copy of the rigid-body math, shared by :meth:`forward` and
:meth:`entries_step`; the CUDA kernels' ``AcrobotEnv::step``
(``csrc/acrobot.cuh``) is a line-for-line copy of it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ...utils.batch import bclamp
from ..dynamics import Dynamics
from .frame import frame_inputs

_G = 9.8


@dataclasses.dataclass(frozen=True, eq=False)
class AcrobotDx(Dynamics):
    params: torch.Tensor  # (4,) = (m1, m2, l1, l2), or per-scenario (B, 4)
    max_torque: float = 4.0
    max_speed1: float = 4.0 * math.pi
    max_speed2: float = 9.0 * math.pi
    dt: float = 0.01
    clamp_ctrl: bool = True
    n_state: int = 6
    n_ctrl: int = 1

    @staticmethod
    def default(dtype=torch.float32, device="cuda") -> "AcrobotDx":
        """The acrobot with unit masses and lengths, on the card unless
        ``device`` says otherwise (without a card that raises)."""
        return AcrobotDx(params=torch.tensor([1.0, 1.0, 1.0, 1.0], dtype=dtype, device=device))

    def _split_params(self):
        # trailing-axis indexing so per-scenario (B, 4) params broadcast
        # against (..., B) state entries
        return tuple(self.params[..., i] for i in range(4))

    def _accelerations(self, p, c1, s1, c2, s2, om1, om2, tau):
        """Closed-form ``qdd = M(q)^{-1} (B tau - C(q, qd) qd - G(q))``;
        ``p`` is ``(m1, m2, l1, l2)``."""
        m1, m2, l1, l2 = p
        lc1, lc2 = 0.5 * l1, 0.5 * l2
        i1 = m1 * l1 * l1 / 12.0
        i2 = m2 * l2 * l2 / 12.0

        m11 = m1 * lc1 * lc1 + i1 + m2 * (l1 * l1 + lc2 * lc2 + 2.0 * l1 * lc2 * c2) + i2
        m12 = m2 * (lc2 * lc2 + l1 * lc2 * c2) + i2
        m22 = m2 * lc2 * lc2 + i2

        h = m2 * l1 * lc2 * s2
        cor1 = -h * om2 * om2 - 2.0 * h * om1 * om2
        cor2 = h * om1 * om1

        # th from upright: U = (m1 lc1 + m2 l1) g cos th1 + m2 lc2 g cos(th1 + th2)
        s12 = s1 * c2 + c1 * s2
        g1 = -(m1 * lc1 + m2 * l1) * _G * s1 - m2 * lc2 * _G * s12
        g2 = -m2 * lc2 * _G * s12

        b1 = -cor1 - g1
        b2 = tau - cor2 - g2
        det = m11 * m22 - m12 * m12
        qdd1 = (m22 * b1 - m12 * b2) / det
        qdd2 = (m11 * b2 - m12 * b1) / det
        return qdd1, qdd2

    def forward(self, x, u):
        c1, s1, c2, s2, om1, om2 = (x[..., i] for i in range(6))
        tau = u[..., 0]
        if self.clamp_ctrl:
            tau = bclamp(tau, -self.max_torque, self.max_torque)
        qdd1, qdd2 = self._accelerations(self._split_params(), c1, s1, c2, s2, om1, om2, tau)
        nom1 = bclamp(om1 + self.dt * qdd1, -self.max_speed1, self.max_speed1)
        nom2 = bclamp(om2 + self.dt * qdd2, -self.max_speed2, self.max_speed2)
        th1 = torch.atan2(s1, c1) + self.dt * nom1
        th2 = torch.atan2(s2, c2) + self.dt * nom2
        return torch.stack([torch.cos(th1), torch.sin(th1), torch.cos(th2), torch.sin(th2), nom1, nom2], dim=-1)

    def entries_step(self, params, x_entries, u_entries):
        """Entry-wise step for the fused solve (each entry a ``(B,)`` tensor,
        ``params`` a list of scalars or ``(B,)`` rows): the shared
        :meth:`_accelerations`, with the angle updates as rotation
        identities instead of ``atan2``."""
        c1, s1, c2, s2, om1, om2 = x_entries
        tau = u_entries[0]
        if self.clamp_ctrl:
            tau = bclamp(tau, -self.max_torque, self.max_torque)
        qdd1, qdd2 = self._accelerations(tuple(params), c1, s1, c2, s2, om1, om2, tau)
        nom1 = bclamp(om1 + self.dt * qdd1, -self.max_speed1, self.max_speed1)
        nom2 = bclamp(om2 + self.dt * qdd2, -self.max_speed2, self.max_speed2)

        def rotate(c, s, d):
            inv_r = torch.rsqrt(c * c + s * s)
            c_hat, s_hat = c * inv_r, s * inv_r
            cd, sd = torch.cos(d), torch.sin(d)
            return c_hat * cd - s_hat * sd, s_hat * cd + c_hat * sd

        nc1, ns1 = rotate(c1, s1, self.dt * nom1)
        nc2, ns2 = rotate(c2, s2, self.dt * nom2)
        return [nc1, ns1, nc2, ns2, nom1, nom2]

    # grad_input: the protocol's exact forward-mode autodiff of forward

    def get_true_obj(self, dtype=None):
        """Balance cost ingredients ``(q, p)``: weights toward the upright
        goal ``(1, 0, 1, 0, 0, 0)`` and a control penalty."""
        if self.param_batch_shape:
            raise ValueError(
                "get_true_obj uses shared params; per-scenario costs go "
                "through the (T, B, ...) QuadCost contract directly"
            )
        dtype = dtype or self.params.dtype
        kw = dict(dtype=dtype, device=self.params.device)
        goal_weights = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.1, 0.1], **kw)
        goal_state = torch.tensor([1.0, 0.0, 1.0, 0.0, 0.0, 0.0], **kw)
        ctrl_penalty = 0.001
        q = torch.cat([goal_weights, ctrl_penalty * torch.ones(self.n_ctrl, **kw)])
        p = torch.cat([-goal_weights * goal_state, torch.zeros(self.n_ctrl, **kw)])
        return q, p

    def get_frame(self, x, ax=None):
        """Render one matplotlib frame: the two links from the pivot. ``x`` is
        a tensor on any device or an array; host-side, requires matplotlib."""
        import matplotlib.pyplot as plt

        x, params = frame_inputs(self, x)
        th1 = float(np.arctan2(x[1], x[0]))
        th2 = float(np.arctan2(x[3], x[2]))
        l1, l2 = float(params[2]), float(params[3])
        if ax is None:
            _, ax = plt.subplots(figsize=(4, 4))
        x1, y1 = l1 * np.sin(th1), l1 * np.cos(th1)
        x2 = x1 + l2 * np.sin(th1 + th2)
        y2 = y1 + l2 * np.cos(th1 + th2)
        ax.plot([0.0, x1], [0.0, y1], color="k", lw=3)
        ax.plot([x1, x2], [y1, y2], color="b", lw=3)
        lim = 1.2 * (l1 + l2)
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        return ax
