"""Cartpole MPC imitation learning: learn the cost and the dynamics through the KKT backward.

BASELINE.json config 4 (B=4096): expert controls come from MPC with the true
cartpole params and the true quadratic cost; the learner recovers the
physical parameters ``(g, m_cart, m_pole, l)`` and the log-parameterized
diagonal cost weights (``--learn dynamics|cost|both``) by MSE on controls,
every gradient flowing through the analytic KKT fixed-point backward.

Run with ``python -m diffmpc_tpu_torch.examples.il_cartpole`` on a machine
with a CUDA card (it raises without one), or with ``--cpu`` on the plain
versions. The flags are those of ``examples/il_cartpole.py``; it writes the
same ``train.csv`` columns and prints the same final lines.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from diffmpc_tpu_torch import MPCConfig, QuadCost
from diffmpc_tpu_torch.examples import common
from diffmpc_tpu_torch.models import CartpoleDx

U_LIM = 10.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--lqr-iter", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--learn", choices=["dynamics", "cost", "both"], default="both")
    common.add_run_flags(ap, "results/il_cartpole", 50, "shard the batch over the ranks")
    return ap.parse_args(argv)


def build(args, device) -> dict:
    """The expert's model and cost, the starts, the box ±10, the config and
    the learner's first params: ``{"dyn"}`` the perturbed physics and / or
    ``{"logq"}`` the perturbed log cost weights, and ``make_problem``, which
    keeps the true goal (``p = -q * goal``)."""
    dtype = torch.float32
    dx = CartpoleDx.default(dtype, device=device)
    q_true, p_true = dx.get_true_obj()
    cost = QuadCost(torch.diag(q_true), p_true)
    config = MPCConfig(n_state=5, n_ctrl=1, T=args.horizon, lqr_iter=args.lqr_iter, eps=1e-5,
                       exit_unconverged=False, detach_unconverged=True)
    rng = np.random.default_rng(args.seed + 1)
    dyn0 = torch.tensor(dx.params.cpu().numpy() * rng.uniform(0.75, 1.25, 4), dtype=dtype, device=device)
    logq0 = torch.log(q_true) + torch.tensor(rng.uniform(-0.5, 0.5, q_true.shape[0]), dtype=dtype, device=device)
    params0 = {}
    if args.learn in ("dynamics", "both"):
        params0["dyn"] = dyn0
    if args.learn in ("cost", "both"):
        params0["logq"] = logq0
    goal = torch.tensor([0.0, 0.0, 1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)

    def make_problem(params):
        problem_dx = dx.replace(params=params["dyn"]) if "dyn" in params else dx
        if "logq" not in params:
            return cost, problem_dx
        q = torch.exp(params["logq"])
        return QuadCost(torch.diag_embed(q), -q * goal.to(q)), problem_dx  # the params' device and dtype

    return dict(config=config, cost=cost, dx=dx, x_init=common.random_cartpole_x_init(args.batch, args.seed, dtype,
                                                                                       device),
                lo=-U_LIM, hi=U_LIM, params0=params0, make_problem=make_problem)


def table(i, stats, params, dt):
    out = (("step", i), ("loss", stats["loss"], "{:.3e}"), ("conv", stats["converged_frac"], "{:.2f}"))
    return out + ((("dyn", np.round(params["dyn"], 3)),) if "dyn" in params else ())


def main(argv=None):
    args = parse_args(argv)
    device = common.pick_device(args, "il_cartpole")
    b = build(args, device)
    print("generating expert data; true params", b["dx"].params.cpu().numpy())
    state, _, final = common.train(args, b, device, tag="il_cartpole", table=table)
    if "dyn" in final:
        print("learned dyn", final["dyn"], "true", b["dx"].params.cpu().numpy())
    if "logq" in final:
        print("learned q", np.exp(final["logq"]), "true", b["cost"].C.diagonal().cpu().numpy())
    return state


if __name__ == "__main__":
    main()
