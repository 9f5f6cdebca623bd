"""Differentiable cartpole (counterpart of
:class:`diffmpc_tpu.models.envs.cartpole.CartpoleDx`).

State ``(p, pdot, cos th, sin th, thdot)``, force control (clamped to
``+-max_force`` only with ``clamp_ctrl``), learnable params
``(g, m_cart, m_pole, l)``: the Barto-Sutton cartpole ODE, Euler-integrated
in the cos/sin angle encoding with ``dt = 0.05``.
:meth:`CartpoleDx.entries_step` is the step the fused solve linearizes; the
CUDA kernels' ``CartpoleEnv::step`` (``csrc/cartpole.cuh``) is a
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
class CartpoleDx(Dynamics):
    params: torch.Tensor  # (4,) = (g, m_cart, m_pole, l), or per-scenario (B, 4)
    dt: float = 0.05
    max_force: float = 100.0
    clamp_ctrl: bool = False
    n_state: int = 5
    n_ctrl: int = 1

    @staticmethod
    def default(dtype=torch.float32, device="cuda") -> "CartpoleDx":
        """The cartpole with ``(g, m_cart, m_pole, l) = (9.8, 1, 0.1, 0.5)``,
        on the card unless ``device`` says otherwise (without a card that
        raises)."""
        return CartpoleDx(params=torch.tensor([9.8, 1.0, 0.1, 0.5], dtype=dtype, device=device))

    def forward(self, x, u):
        # trailing-axis indexing so per-scenario (B, 4) params broadcast
        # against (..., B) state entries
        g, m_cart, m_pole, l = (self.params[..., i] for i in range(4))
        total_mass = m_cart + m_pole
        polemass_l = m_pole * l

        p, pdot = x[..., 0], x[..., 1]
        cos_th, sin_th, thdot = x[..., 2], x[..., 3], x[..., 4]
        force = u[..., 0]
        if self.clamp_ctrl:
            force = bclamp(force, -self.max_force, self.max_force)
        th = torch.atan2(sin_th, cos_th)

        temp = (force + polemass_l * thdot**2 * sin_th) / total_mass
        th_acc = (g * sin_th - cos_th * temp) / (l * (4.0 / 3.0 - m_pole * cos_th**2 / total_mass))
        p_acc = temp - polemass_l * th_acc * cos_th / total_mass

        p_new = p + self.dt * pdot
        pdot_new = pdot + self.dt * p_acc
        th_new = th + self.dt * thdot
        thdot_new = thdot + self.dt * th_acc
        return torch.stack([p_new, pdot_new, torch.cos(th_new), torch.sin(th_new), thdot_new], dim=-1)

    def entries_step(self, params, x_entries, u_entries):
        """Entry-wise step for the fused solve: each entry is a ``(B,)``
        tensor and ``params`` a list of scalars or ``(B,)`` rows. Equal to
        :meth:`forward` in exact arithmetic, with the angle update written
        through the rotation identity instead of ``atan2``."""
        g, m_cart, m_pole, l = params
        total_mass = m_cart + m_pole
        polemass_l = m_pole * l
        p, pdot, cos_th, sin_th, thdot = x_entries
        force = u_entries[0]
        if self.clamp_ctrl:
            force = bclamp(force, -self.max_force, self.max_force)
        temp = (force + polemass_l * thdot * thdot * sin_th) / total_mass
        th_acc = (g * sin_th - cos_th * temp) / (l * (4.0 / 3.0 - m_pole * cos_th * cos_th / total_mass))
        p_acc = temp - polemass_l * th_acc * cos_th / total_mass
        inv_r = torch.rsqrt(cos_th * cos_th + sin_th * sin_th)
        c_hat, s_hat = cos_th * inv_r, sin_th * inv_r
        d = self.dt * thdot
        cd, sd = torch.cos(d), torch.sin(d)
        return [
            p + self.dt * pdot,
            pdot + self.dt * p_acc,
            c_hat * cd - s_hat * sd,
            s_hat * cd + c_hat * sd,
            thdot + self.dt * th_acc,
        ]

    # grad_input: the protocol's exact forward-mode autodiff of forward

    def get_true_obj(self, dtype=None):
        """Quadratic cost ingredients ``(q, p)`` toward the upright, centred
        pole: ``C = diag(q)``, ``c = p``."""
        dtype = dtype or self.params.dtype
        kw = dict(dtype=dtype, device=self.params.device)
        goal_weights = torch.tensor([0.1, 0.1, 1.0, 1.0, 0.1], **kw)
        goal_state = torch.tensor([0.0, 0.0, 1.0, 0.0, 0.0], **kw)
        ctrl_penalty = 0.001
        q = torch.cat([goal_weights, ctrl_penalty * torch.ones(self.n_ctrl, **kw)])
        p = torch.cat([-goal_weights * goal_state, torch.zeros(self.n_ctrl, **kw)])
        return q, p

    def get_frame(self, x, ax=None):
        """Render one matplotlib frame: the cart and its pole. ``x`` is a
        tensor on any device or an array; host-side, requires matplotlib."""
        import matplotlib.pyplot as plt

        x, params = frame_inputs(self, x)
        p = float(x[0])
        th = float(np.arctan2(x[3], x[2]))
        l = float(params[3])
        if ax is None:
            _, ax = plt.subplots(figsize=(6, 4))
        cart_w, cart_h = 0.4, 0.2
        ax.add_patch(plt.Rectangle((p - cart_w / 2, -cart_h / 2), cart_w, cart_h, color="k"))
        ax.plot([p, p + 2 * l * np.sin(th)], [0, 2 * l * np.cos(th)], color="b", lw=3)
        ax.set_xlim(p - 3, p + 3)
        ax.set_ylim(-1.5, 1.5)
        return ax
