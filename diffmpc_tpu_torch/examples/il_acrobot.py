"""Imitation learning of acrobot dynamics through the MPC solver.

The sysid recipe of ``il_pendulum`` on the underactuated double pendulum
(n=6, m=1, the elbow-torque box ``|u| <= 4``): recover the rod parameters
``(m1, m2, l1, l2)`` from expert near-upright balance controls by MSE
through the analytic KKT backward. The mass matrix depends on the
configuration, so the parameters reach the linearized dynamics through a
state-dependent 2x2 solve. The params are learned as ``log params``; the
balance data pins the torque-relevant combinations more tightly than each
rod, so the control MSE is the headline and the parameter distance stands
beside it. ``dt = 0.01``: the horizon counts 10 ms steps.

Run with ``python -m diffmpc_tpu_torch.examples.il_acrobot`` on a machine
with a CUDA card (it raises without one), or with ``--cpu`` on the plain
versions. The flags are those of ``examples/il_acrobot.py``; it writes the
same ``train.csv`` columns and prints the same final lines.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from diffmpc_tpu_torch import MPCConfig, QuadCost
from diffmpc_tpu_torch.examples import common
from diffmpc_tpu_torch.models import AcrobotDx


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--horizon", type=int, default=25)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--lqr-iter", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init-scale", type=float, default=0.08, help="near-upright perturbation scale of the experts")
    common.add_run_flags(ap, "results/il_acrobot", 50, "shard the batch over the ranks")
    return ap.parse_args(argv)


def build(args, device) -> dict:
    """The expert's model and cost, the near-upright starts, the box ±4, the
    config, the learner's perturbed log params and ``make_problem``."""
    dtype = torch.float32
    dx = AcrobotDx.default(dtype, device=device)
    q, p = dx.get_true_obj()
    cost = QuadCost(torch.diag(q), p)
    config = MPCConfig(n_state=6, n_ctrl=1, T=args.horizon, lqr_iter=args.lqr_iter, eps=1e-5,
                       exit_unconverged=False, detach_unconverged=True)
    rng = np.random.default_rng(args.seed + 1)
    params0 = torch.log(torch.tensor(dx.params.cpu().numpy() * rng.uniform(0.8, 1.2, 4), dtype=dtype,
                                     device=device))

    def make_problem(log_params):
        return cost, dx.replace(params=torch.exp(log_params))

    x_init = common.random_acrobot_x_init(args.batch, args.seed, dtype, device, scale=args.init_scale)
    return dict(config=config, cost=cost, dx=dx, x_init=x_init, lo=-dx.max_torque, hi=dx.max_torque,
                params0=params0, make_problem=make_problem)


def main(argv=None):
    args = parse_args(argv)
    device = common.pick_device(args, "il_acrobot")
    b = build(args, device)
    true = b["dx"].params.cpu().numpy()
    print("generating expert data with true params", true)

    def row(log_params):
        m1, m2, l1, l2 = p = np.exp(log_params)
        return dict(m1=m1, m2=m2, l1=l1, l2=l2, param_dist=float(np.linalg.norm(p - true)))

    def table(i, stats, log_params, dt):
        return (("step", i), ("loss", stats["loss"], "{:.3e}"),
                ("|p-p*|", float(np.linalg.norm(np.exp(log_params) - true)), "{:.3f}"),
                ("conv", stats["converged_frac"], "{:.2f}"))

    state, _, final = common.train(args, b, device, tag="il_acrobot", columns=["m1", "m2", "l1", "l2", "param_dist"],
                                   row=row, table=table)
    final = np.exp(final)
    print("final params", np.round(final, 4), "true", true)
    print(f"param distance {np.linalg.norm(final - true):.4f} "
          f"(init {np.linalg.norm(np.exp(b['params0'].cpu().numpy()) - true):.4f})")
    return state


if __name__ == "__main__":
    main()
