"""Imitation learning of planar-quadrotor dynamics through the MPC solver.

The sysid recipe of ``il_pendulum`` on the multi-control env (n=6, m=2,
the asymmetric thrust box ``0 <= u <= max``): recover ``(g, mass, arm,
inertia)`` from expert hover-stabilization controls by MSE through the
analytic KKT backward, at ``lqr_iter=14``. The params span three orders of
magnitude, so they are learned as ``log params``; the expert's controls pin
``g * mass`` and ``arm / inertia`` tightly, which the final lines report.

Run with ``python -m diffmpc_tpu_torch.examples.il_quadrotor`` on a machine
with a CUDA card (it raises without one), or with ``--cpu`` on the plain
versions. The flags are those of ``examples/il_quadrotor.py``; it writes the
same ``train.csv`` columns and prints the same final lines.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from diffmpc_tpu_torch import MPCConfig, QuadCost
from diffmpc_tpu_torch.examples import common
from diffmpc_tpu_torch.models import QuadrotorDx


def random_quadrotor_x_init(B: int, seed: int = 0, dtype=torch.float32, device="cpu", scale: float = 0.25):
    """Starts off hover: a position offset of ``scale`` and small angle and
    speeds."""
    rng = np.random.default_rng(seed)
    return torch.tensor(np.stack([rng.uniform(-scale, scale, B), rng.uniform(-scale, scale, B)]
                                 + [rng.uniform(-0.2, 0.2, B) for _ in range(4)], -1), dtype=dtype, device=device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--lqr-iter", type=int, default=14)
    ap.add_argument("--seed", type=int, default=0)
    common.add_run_flags(ap, "results/il_quadrotor", 50, "shard the batch over the ranks")
    return ap.parse_args(argv)


def build(args, device) -> dict:
    """The expert's model and cost, the starts, the box ``[0,
    max_thrust]``, the config, the learner's perturbed log params and
    ``make_problem``."""
    dtype = torch.float32
    dx = QuadrotorDx.default(dtype, device=device)
    q, p = dx.get_true_obj()
    cost = QuadCost(torch.diag(q), p)
    config = MPCConfig(n_state=6, n_ctrl=2, T=args.horizon, lqr_iter=args.lqr_iter, eps=1e-5,
                       exit_unconverged=False, detach_unconverged=True)
    rng = np.random.default_rng(args.seed + 1)
    params0 = torch.log(torch.tensor(dx.params.cpu().numpy() * rng.uniform(0.75, 1.25, 4), dtype=dtype,
                                     device=device))

    def make_problem(log_params):
        return cost, dx.replace(params=torch.exp(log_params))

    return dict(config=config, cost=cost, dx=dx, x_init=random_quadrotor_x_init(args.batch, args.seed, dtype, device),
                lo=0.0, hi=dx.max_thrust, params0=params0, make_problem=make_problem)


def row(log_params) -> dict:
    g, mass, arm, inertia = np.exp(log_params)
    return dict(g=g, mass=mass, arm=arm, inertia=inertia)


def table(i, stats, log_params, dt):
    g, mass, arm, inertia = np.exp(log_params)
    return (("step", i), ("loss", stats["loss"], "{:.3e}"), ("g*mass", g * mass, "{:.3f}"),
            ("arm/I", arm / inertia, "{:.2f}"), ("conv", stats["converged_frac"], "{:.2f}"))


def main(argv=None):
    args = parse_args(argv)
    device = common.pick_device(args, "il_quadrotor")
    b = build(args, device)
    true = b["dx"].params.cpu().numpy()
    print("generating expert data with true params", true)
    state, _, final = common.train(args, b, device, tag="il_quadrotor", columns=["g", "mass", "arm", "inertia"],
                                   row=row, table=table)
    final = np.exp(final)
    print("final params", np.round(final, 4), "true", true)
    print(f"identified combinations: g*mass {final[0]*final[1]:.4f} (true {true[0]*true[1]:.4f}), arm/inertia "
          f"{final[2]/final[3]:.2f} (true {true[2]/true[3]:.2f})")
    return state


if __name__ == "__main__":
    main()
