"""Imitation learning of vehicle dynamics through the MPC solver.

The sysid recipe on the kinematic-bicycle vehicle (n=4, m=2): recover
``(wheelbase L, drag c_d)`` from expert lane-keeping controls by MSE through
the analytic KKT backward, with the asymmetric per-dimension box (accel
``[-6, 3]``, steer ``|delta| <= 0.5``) active on the experts. The params
are learned as ``log params``, which keeps the wheelbase and the drag
positive.

Run with ``python -m diffmpc_tpu_torch.examples.il_vehicle`` on a machine
with a CUDA card (it raises without one), or with ``--cpu`` on the plain
versions. The flags are those of ``examples/il_vehicle.py``; it writes the
same ``train.csv`` columns and prints the same final lines.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from diffmpc_tpu_torch import MPCConfig, QuadCost
from diffmpc_tpu_torch.examples import common
from diffmpc_tpu_torch.models import VehicleDx


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--lqr-iter", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    common.add_run_flags(ap, "results/il_vehicle", 50, "shard the batch over the ranks")
    return ap.parse_args(argv)


def build(args, device) -> dict:
    """The expert's model and cost, the lane-keeping starts, the
    per-dimension box, the config, the learner's perturbed log params and
    ``make_problem``."""
    dtype = torch.float32
    dx = VehicleDx.default(dtype, device=device)
    q, p = dx.get_true_obj()
    cost = QuadCost(torch.diag(q), p)
    config = MPCConfig(n_state=4, n_ctrl=2, T=args.horizon, lqr_iter=args.lqr_iter, eps=1e-5,
                       exit_unconverged=False, detach_unconverged=True)
    lo = torch.tensor([-dx.max_brake, -dx.max_steer], dtype=dtype, device=device)
    hi = torch.tensor([dx.max_accel, dx.max_steer], dtype=dtype, device=device)
    rng = np.random.default_rng(args.seed + 1)
    params0 = torch.log(torch.tensor(dx.params.cpu().numpy() * rng.uniform(0.7, 1.3, 2), dtype=dtype,
                                     device=device))

    def make_problem(log_params):
        return cost, dx.replace(params=torch.exp(log_params))

    return dict(config=config, cost=cost, dx=dx, x_init=common.random_vehicle_x_init(args.batch, args.seed, dtype,
                                                                                      device),
                lo=lo, hi=hi, params0=params0, make_problem=make_problem)


def learned(log_params) -> np.ndarray:
    return np.exp(log_params)


def main(argv=None):
    args = parse_args(argv)
    device = common.pick_device(args, "il_vehicle")
    b = build(args, device)
    true = b["dx"].params.cpu().numpy()
    print("generating expert data with true params", true)

    def row(log_params):
        p = learned(log_params)
        return dict(wheelbase=p[0], drag=p[1], param_dist=float(np.linalg.norm(p - true)))

    def table(i, stats, log_params, dt):
        p = learned(log_params)
        return (("step", i), ("loss", stats["loss"], "{:.3e}"), ("L", p[0], "{:.3f}"), ("c_d", p[1], "{:.3f}"),
                ("conv", stats["converged_frac"], "{:.2f}"))

    state, _, final = common.train(args, b, device, tag="il_vehicle", columns=["wheelbase", "drag", "param_dist"],
                                   row=row, table=table)
    final = learned(final)
    print("final params", np.round(final, 4), "true", true)
    print(f"param distance {np.linalg.norm(final - true):.4f} "
          f"(init {np.linalg.norm(learned(b['params0'].cpu().numpy()) - true):.4f})")
    return state


if __name__ == "__main__":
    main()
