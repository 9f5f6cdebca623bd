"""Imitation learning with a neural dynamics model through the MPC solver.

Expert controls come from MPC with the true pendulum physics; the learner's
MPC uses an MLP state-transition model (``NNDynamics``, residual, tanh)
whose weights are trained end to end by MSE on controls, the gradient
flowing through the analytic KKT backward into the network through the
autodiff linearization of the last iLQR step (``GradMethods.AUTO_DIFF``).
The starts are near upright, where the optimal controls stay inside the
box: from swing-up starts an untrained network saturates every control and
the backward's tight-control masking zeroes every gradient.

The default ``--hidden 64 64`` is past the fused kernels' gate (width <= 32,
<= 1024 params), so its solves take the non-fused loop, as the JAX
package's dispatch does: the Riccati kernel an iteration and the line
search's ladder in PyTorch through the network. A network the gate takes
(``--hidden 16 16``) runs in the fused kernel.

Run with ``python -m diffmpc_tpu_torch.examples.il_nn_dynamics`` on a machine
with a CUDA card (it raises without one), or with ``--cpu`` on the plain
versions. The flags are those of ``examples/il_nn_dynamics.py``; it writes
the same ``train.csv`` columns and prints the same final line. The initial
weights are drawn by a ``torch.Generator`` seeded with ``--seed``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from diffmpc_tpu_torch import GradMethods, MPCConfig, QuadCost
from diffmpc_tpu_torch.examples import common
from diffmpc_tpu_torch.models import NNDynamics, PendulumDx


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--horizon", type=int, default=15)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--hidden", type=int, nargs="+", default=[64, 64])
    ap.add_argument("--lqr-iter", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    common.add_run_flags(ap, "results/il_nn_dynamics", 100, "shard the batch over the ranks")
    return ap.parse_args(argv)


def build(args, device) -> dict:
    """The expert's (true pendulum) model and cost, the near-upright starts,
    the box ±2, the config (``AUTO_DIFF``, no detach of unconverged
    solves: an untrained network seldom converges early, and detaching
    would cut every gradient), the network's first weights as ``{"w":
    weights, "b": biases}`` and ``make_problem``."""
    dtype = torch.float32
    true_dx = PendulumDx.default(dtype, device=device)
    q, p = true_dx.get_true_obj()
    cost = QuadCost(torch.diag(q), p)
    config = MPCConfig(n_state=3, n_ctrl=1, T=args.horizon, lqr_iter=args.lqr_iter, eps=1e-5,
                       grad_method=GradMethods.AUTO_DIFF, exit_unconverged=False, detach_unconverged=False)
    rng = np.random.default_rng(args.seed)
    th = rng.uniform(-0.6, 0.6, args.batch)
    x_init = torch.tensor(np.stack([np.cos(th), np.sin(th), rng.uniform(-0.5, 0.5, args.batch)], -1), dtype=dtype,
                          device=device)
    nn0 = NNDynamics.init(3, 1, hidden=tuple(args.hidden), activation="tanh", residual=True, dtype=dtype,
                          device=device, generator=torch.Generator(device=device).manual_seed(args.seed))

    def make_problem(params):
        return cost, nn0.replace(weights=tuple(params["w"]), biases=tuple(params["b"]))

    return dict(config=config, cost=cost, dx=true_dx, x_init=x_init, lo=-2.0, hi=2.0,
                params0={"w": nn0.weights, "b": nn0.biases}, make_problem=make_problem)


def table(i, stats, params, dt):
    return (("step", i), ("loss", stats["loss"], "{:.3e}"), ("gnorm", stats["grad_norm"], "{:.2e}"),
            ("conv", stats["converged_frac"], "{:.2f}"), ("s/step", dt, "{:.2f}"))


def main(argv=None):
    args = parse_args(argv)
    device = common.pick_device(args, "il_nn_dynamics")
    return run(args, build(args, device), device)


def run(args, b: dict, device):
    """Train on ``b`` (this module's ``build``, its ``params0`` free to be
    replaced) and print the final line; returns the final state."""
    state, stats, _ = common.train(args, b, device, tag="il_nn", table=table, log_every=20)
    print("done; final loss", stats["loss"] if stats else None)
    return state


if __name__ == "__main__":
    main()
