"""Imitation learning of pendulum dynamics parameters through the MPC solver.

The headline experiment (BASELINE.json config 3 at B=1024): expert controls
come from MPC with the true dynamics (g, m, l); the learner starts from
perturbed parameters and minimizes MSE(learned-model MPC controls, expert
controls), the gradient flowing through the analytic KKT backward, and
(g, m, l) recover.

Run with ``python -m diffmpc_tpu_torch.examples.il_pendulum`` on a machine
with a CUDA card (it raises without one), or with ``--cpu`` on the plain
versions. The flags are those of ``examples/il_pendulum.py``; it writes the
same ``train.csv`` columns and prints the same final line. ``--mesh``
shards the batch over the ranks of ``torchrun`` (or one rank alone),
``--resume`` continues from the newest checkpoint, ``--profile-dir``
traces the loop with ``torch.profiler``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from diffmpc_tpu_torch import MPCConfig, QuadCost
from diffmpc_tpu_torch.examples import common
from diffmpc_tpu_torch.models import PendulumDx


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--lqr-iter", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    common.add_run_flags(ap, "results/il_pendulum", 50, "shard the batch over the ranks")
    ap.add_argument("--profile-dir", default=None, help="trace the training loop with torch.profiler here")
    return ap.parse_args(argv)


def build(args, device) -> dict:
    """The expert's (true) model and cost, the starts, the box, the config,
    the learner's perturbed (g, m, l) and ``make_problem(params) -> (cost,
    dx)``."""
    dtype = torch.float32
    dx = PendulumDx.default(dtype, device=device)
    q, p = dx.get_true_obj()
    cost = QuadCost(torch.diag(q), p)
    config = MPCConfig(n_state=3, n_ctrl=1, T=args.horizon, lqr_iter=args.lqr_iter, eps=1e-5,
                       exit_unconverged=False, detach_unconverged=True)
    rng = np.random.default_rng(args.seed + 1)
    params0 = torch.tensor(dx.params.cpu().numpy() * rng.uniform(0.7, 1.3, 3), dtype=dtype, device=device)

    def make_problem(params):
        return cost, dx.replace(params=params)

    return dict(config=config, cost=cost, dx=dx, x_init=common.random_pendulum_x_init(args.batch, args.seed, dtype,
                                                                                       device),
                lo=-2.0, hi=2.0, params0=params0, make_problem=make_problem)


def row(params) -> dict:
    g, m, l = params
    return dict(g=g, m=m, l=l)


def table(i, stats, params, dt):
    g, m, l = params
    return (("step", i), ("loss", stats["loss"], "{:.3e}"), ("g", g, "{:.3f}"), ("m", m, "{:.3f}"), ("l", l, "{:.3f}"),
            ("conv", stats["converged_frac"], "{:.2f}"))


def main(argv=None):
    args = parse_args(argv)
    device = common.pick_device(args, "il_pendulum")
    b = build(args, device)
    print("generating expert data with true params", b["dx"].params.cpu().numpy())
    state, _, final = common.train(args, b, device, tag="il_pendulum", columns=["g", "m", "l"], row=row, table=table)
    print("final params", final, "true", b["dx"].params.cpu().numpy())
    return state


if __name__ == "__main__":
    main()
