"""Generate expert MPC trajectories for offline imitation learning.

Solves batched MPC with the true cost and dynamics of the chosen env
(pendulum, cartpole, acrobot near upright, or the vehicle with its
per-dimension box) and writes ``x_init``, ``xs``, ``us``, ``objs`` and
``env`` to an ``.npz``.

Run with ``python -m diffmpc_tpu_torch.examples.gen_expert_data --env
cartpole`` on a machine with a CUDA card (it raises without one), or with
``--cpu`` on the plain versions. The flags are those of
``examples/gen_expert_data.py``, and so are the ``.npz`` keys.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from diffmpc_tpu_torch import MPCConfig, QuadCost
from diffmpc_tpu_torch.examples import common
from diffmpc_tpu_torch.models import AcrobotDx, CartpoleDx, PendulumDx, VehicleDx
from diffmpc_tpu_torch.parallel import generate_expert_data

ENVS = {  # the model, its starts and its box (the vehicle's per dimension, below)
    "pendulum": (PendulumDx, common.random_pendulum_x_init, 2.0),
    "cartpole": (CartpoleDx, common.random_cartpole_x_init, 10.0),
    "acrobot": (AcrobotDx, common.random_acrobot_x_init, 4.0),
    "vehicle": (VehicleDx, common.random_vehicle_x_init, None),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--env", choices=list(ENVS), default="pendulum")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--lqr-iter", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU")
    ap.add_argument("--out", default="expert_data.npz")
    return ap.parse_args(argv)


def build(args, device) -> dict:
    """The env's true model and cost, its starts, its box and the config."""
    model, x_init, u_lim = ENVS[args.env]
    dx = model.default(torch.float32, device=device)
    if u_lim is None:  # the vehicle: accel [-max_brake, max_accel], steer ±max_steer
        lo = torch.tensor([-dx.max_brake, -dx.max_steer], device=device)
        hi = torch.tensor([dx.max_accel, dx.max_steer], device=device)
    else:
        lo, hi = -u_lim, u_lim
    q, p = dx.get_true_obj()
    config = MPCConfig(n_state=dx.n_state, n_ctrl=dx.n_ctrl, T=args.horizon, lqr_iter=args.lqr_iter, eps=1e-5,
                       exit_unconverged=False)
    return dict(config=config, cost=QuadCost(torch.diag(q), p), dx=dx,
                x_init=x_init(args.batch, args.seed, torch.float32, device), lo=lo, hi=hi)


def main(argv=None):
    args = parse_args(argv)
    device = common.pick_device(args, "gen_expert_data")
    b = build(args, device)
    xs, us, objs = generate_expert_data(b["config"], b["cost"], b["dx"], b["x_init"], b["lo"], b["hi"])
    out = dict(x_init=b["x_init"], xs=xs, us=us, objs=objs)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    np.savez(args.out, **out, env=args.env)
    print(f"wrote {args.out}: us {tuple(us.shape)}, mean obj {float(objs.mean()):.4f}")
    return out


if __name__ == "__main__":
    main()
