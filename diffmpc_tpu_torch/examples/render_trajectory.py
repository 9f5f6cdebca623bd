"""Render an MPC-controlled trajectory to PNG frames / an animated GIF.

The counterpart of ``examples/render_trajectory.py``: the receding-horizon
controller runs one robot (B=1) for an episode (:func:`build`,
:func:`episode`: ``run_receding_horizon``, one fused solve an env step, on
the card), and each state it visits is drawn by the env's ``get_frame``
(:func:`render`, on the host).

Run with ``python -m diffmpc_tpu_torch.examples.render_trajectory [--env
pendulum|cartpole|quadrotor|acrobot|vehicle] [--gif out.gif]`` on a machine
with a CUDA card (it raises without one) and matplotlib, or with ``--cpu``
on the plain versions. The flags, the starts, the boxes and the solver's
settings are the JAX script's; it prints the same lines.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from diffmpc_tpu_torch import MPCConfig, QuadCost
from diffmpc_tpu_torch.examples.common import pick_device
from diffmpc_tpu_torch.models import AcrobotDx, CartpoleDx, PendulumDx, QuadrotorDx, VehicleDx
from diffmpc_tpu_torch.models.envs.frame import host
from diffmpc_tpu_torch.receding import run_receding_horizon

ENVS = ("pendulum", "cartpole", "quadrotor", "acrobot", "vehicle")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--env", choices=list(ENVS), default="pendulum")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--horizon", type=int, default=15)
    ap.add_argument("--theta0", type=float, default=0.7, help="initial angle (rad)")
    ap.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU")
    ap.add_argument("--out", default="results/frames")
    ap.add_argument("--gif", default=None, help="optional output .gif path")
    return ap.parse_args(argv)


def build(args, device, dtype=torch.float32):
    """The env's model on ``device``, its goal cost, its box, the one start
    ``x0 (1, n)`` and the config, for ``args``: the pendulum and the cartpole
    tilted by ``theta0``, the quadrotor displaced and tilted (its thrust box
    ``[0, max_thrust]``), the acrobot tilted by ``theta0 / 4`` (its dt=0.01
    model: pass a longer ``--horizon``, e.g. 40, for 0.4 s), the vehicle
    off its lane at speed (heading ``theta0 / 2``, a box per control)."""
    kw = dict(dtype=dtype, device=device)
    t0 = args.theta0
    if args.env == "pendulum":
        dx = PendulumDx.default(dtype, device=device)
        x0 = [np.cos(t0), np.sin(t0), 0.0]
        lo, hi = -2.0, 2.0
    elif args.env == "cartpole":
        dx = CartpoleDx.default(dtype, device=device)
        x0 = [0.0, 0.0, np.cos(t0), np.sin(t0), 0.0]
        lo, hi = -10.0, 10.0
    elif args.env == "quadrotor":  # displaced + tilted hover recovery
        dx = QuadrotorDx.default(dtype, device=device)
        x0 = [0.5, 0.5, t0 / 2, 0.0, 0.0, 0.0]
        lo, hi = 0.0, dx.max_thrust
    elif args.env == "acrobot":  # balance recovery from a small tilt
        dx = AcrobotDx.default(dtype, device=device)
        a = t0 / 4
        x0 = [np.cos(a), np.sin(a), np.cos(-a), np.sin(-a), 0.0, 0.0]
        lo, hi = -4.0, 4.0
    else:  # vehicle: lane recovery from an offset at speed
        dx = VehicleDx.default(dtype, device=device)
        x0 = [0.0, 1.0, t0 / 2, 5.0]
        lo = torch.tensor([-dx.max_brake, -dx.max_steer], **kw)
        hi = torch.tensor([dx.max_accel, dx.max_steer], **kw)
    q, p = dx.get_true_obj()
    config = MPCConfig(n_state=dx.n_state, n_ctrl=dx.n_ctrl, T=args.horizon, lqr_iter=8, eps=1e-5,
                       exit_unconverged=False, detach_unconverged=False)
    return dict(dx=dx, cost=QuadCost(torch.diag(q), p), lo=lo, hi=hi, x0=torch.tensor([x0], **kw), config=config)


def episode(s, n_steps: int):
    """The closed loop for ``n_steps`` env steps from ``s``, what
    :func:`build` returned: ``(xs (n_steps+1, 1, n), us (n_steps, 1, m),
    objs (n_steps, 1))``."""
    with torch.no_grad():
        return run_receding_horizon(s["config"], s["x0"], s["cost"], s["dx"], n_steps, u_lower=s["lo"],
                                    u_upper=s["hi"])


def render(dx, xs, out: str, gif=None) -> list:
    """One PNG a state of ``xs`` (its first scenario) under ``out``, each
    drawn by ``dx.get_frame``, and the GIF of them where ``gif`` names one
    and PIL is present. Returns the PNGs' paths."""
    import matplotlib.pyplot as plt

    xs = host(xs)
    os.makedirs(out, exist_ok=True)
    paths = []
    for t in range(xs.shape[0]):
        fig, ax = plt.subplots(figsize=(4, 4))
        dx.get_frame(xs[t, 0], ax=ax)
        ax.set_title(f"t={t}")
        path = os.path.join(out, f"frame_{t:04d}.png")
        fig.savefig(path, dpi=60)
        plt.close(fig)
        paths.append(path)
    print(f"wrote {len(paths)} frames to {out}")

    if gif:
        try:
            from PIL import Image

            imgs = [Image.open(p) for p in paths]
            imgs[0].save(gif, save_all=True, append_images=imgs[1:], duration=50, loop=0)
            print(f"wrote {gif}")
        except ImportError:
            print("PIL not available; skipped GIF assembly")
    return paths


def main(argv=None) -> list:
    args = parse_args(argv)
    device = pick_device(args, "render_trajectory")
    # before any solve: a machine without matplotlib fails here
    import matplotlib

    matplotlib.use("Agg")
    s = build(args, device)
    xs, _, _ = episode(s, args.steps)
    return render(s["dx"], xs, args.out, args.gif)


if __name__ == "__main__":
    main()
