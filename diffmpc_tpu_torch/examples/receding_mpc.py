"""Closed-loop receding-horizon MPC: the deployment pattern, on the card.

At every environment step the controller solves the T-step problem from
the current state, applies only the first control, and warm-starts the next
solve with the time-shifted rest (:mod:`diffmpc_tpu_torch.receding`). The B
scenarios run the loop in lockstep, each solve one call of ``mpc_solve``.

``--plant-param-error`` steps a true plant with perturbed physics while the
controller plans with the nominal model (re-solving from the measured state
absorbs the mismatch). ``--slew`` adds the slew-rate penalty, anchored
across solves by the last applied control (``prev_ctrl``); its solve is the
control-augmented problem, which the fused kernel runs through its
control-passthrough variant.

Run with ``python -m diffmpc_tpu_torch.examples.receding_mpc --batch 1024
--env-steps 100 --plant-param-error 0.15`` on a machine with a CUDA card
(it raises without one), or with ``--cpu`` on the plain versions. The flags
are those of ``examples/receding_mpc.py``; it prints the same
``[receding_mpc]`` line.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from diffmpc_tpu_torch import MPCConfig, QuadCost
from diffmpc_tpu_torch.models import PendulumDx, VehicleDx
from diffmpc_tpu_torch.receding import run_receding_horizon
from diffmpc_tpu_torch.utils.logging import CSVLogger, table_log


def random_pendulum_x_init(B: int, seed: int = 0, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Swing-up starts: a uniform angle and a speed in [-1, 1] (the JAX
    examples' recipe, examples/common.py:28-32, drawn with numpy)."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, B)
    thdot = rng.uniform(-1.0, 1.0, B)
    return torch.tensor(np.stack([np.cos(th), np.sin(th), thdot], -1), dtype=dtype, device=device)


def random_vehicle_x_init(B: int, seed: int = 0, dtype=torch.float32, device="cpu", py_scale: float = 1.0):
    """Lane-keeping starts: a lateral offset and a heading error at speed
    (examples/common.py:65-79's recipe)."""
    rng = np.random.default_rng(seed)
    x = np.stack([np.zeros(B), rng.uniform(-py_scale, py_scale, B), rng.uniform(-0.3, 0.3, B),
                  rng.uniform(3.0, 7.0, B)], -1)
    return torch.tensor(x, dtype=dtype, device=device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--env", choices=["pendulum", "vehicle"], default="pendulum",
                    help="pendulum swing-up, or vehicle lane keeping (plant error perturbs (L, c_d))")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--env-steps", type=int, default=100)
    ap.add_argument("--lqr-iter", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU")
    ap.add_argument("--plant-param-error", type=float, default=0.0,
                    help="relative perturbation of the plant's params against the controller's nominal model "
                         "(0.15: up to +-15%%)")
    ap.add_argument("--slew", type=float, default=0.0, help="slew-rate penalty weight (prev_ctrl anchored across solves)")
    ap.add_argument("--out", default=None, help="optional CSV log path")
    return ap.parse_args(argv)


def setup(args, device):
    """The controller's model, cost, bounds, starts and config, and the
    perturbed plant, for ``args``."""
    dtype = torch.float32
    B = args.batch
    if args.env == "pendulum":
        model = PendulumDx.default(dtype, device=device)
        lo, hi = -2.0, 2.0
        x0 = random_pendulum_x_init(B, args.seed, dtype, device)
    else:
        model = VehicleDx.default(dtype, device=device)
        lo = torch.tensor([-model.max_brake, -model.max_steer], dtype=dtype, device=device)
        hi = torch.tensor([model.max_accel, model.max_steer], dtype=dtype, device=device)
        x0 = random_vehicle_x_init(B, args.seed, dtype, device)
    n, m = model.n_state, model.n_ctrl
    q, p = model.get_true_obj()
    config = MPCConfig(n_state=n, n_ctrl=m, T=args.horizon, lqr_iter=args.lqr_iter, eps=1e-5,
                       exit_unconverged=False, detach_unconverged=False, backprop=False,
                       slew_rate_penalty=args.slew if args.slew > 0 else None)
    # the plant the controls are applied to: perturbed physics, which the
    # controller never sees
    rng = np.random.default_rng(args.seed + 1)
    true = model.params.cpu().numpy()
    plant = model.replace(params=torch.tensor(
        true * (1.0 + args.plant_param_error * rng.uniform(-1.0, 1.0, true.shape[0])), dtype=dtype, device=device))
    return dict(model=model, plant=plant, cost=QuadCost(torch.diag(q), p), q=q, lo=lo, hi=hi, x0=x0, config=config)


def episode(s, n_steps: int):
    """One closed-loop episode of ``n_steps`` from the setup ``s``."""
    with torch.no_grad():
        return run_receding_horizon(s["config"], s["x0"], s["cost"], s["model"], n_steps,
                                    env_step=s["plant"].forward, u_lower=s["lo"], u_upper=s["hi"])


def metrics(args, s, xs, us) -> dict:
    """Success (the pendulum upright and slow, the vehicle in its lane,
    straight and near its reference speed, at the end), the closed loop's
    stage cost under the nominal objective, and the mean control change."""
    xs, us = xs.cpu().numpy(), us.cpu().numpy()
    n = s["config"].n_state
    if args.env == "pendulum":
        success = (xs[-1, :, 0] > 0.95) & (np.abs(xs[-1, :, 2]) < 1.0)
        goal = np.array([1.0, 0.0, 0.0])
    else:
        v_ref = s["model"].v_ref
        success = (np.abs(xs[-1, :, 1]) < 0.1) & (np.abs(xs[-1, :, 2]) < 0.1) & (np.abs(xs[-1, :, 3] - v_ref) < 1.0)
        goal = np.array([0.0, 0.0, 0.0, v_ref])
    stage = (s["q"].cpu().numpy()[:n] * (xs[:-1] - goal) ** 2).sum(-1)
    return dict(success_frac=float(success.mean()), mean_stage_cost=float(stage.mean()),
                final_stage_cost=float(stage[-1].mean()), mean_abs_du=float(np.abs(np.diff(us, axis=0)).mean()),
                stage=stage)


def main(argv=None) -> float:
    args = parse_args(argv)
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        raise RuntimeError("receding_mpc runs on a CUDA card, and none is present: pass --cpu for the CPU")
    s = setup(args, device)
    print(f"closed-loop {args.env}: B={args.batch}, T={args.horizon}, {args.env_steps} env steps, "
          f"plant error +-{args.plant_param_error:.0%}, device {device}")

    def timed():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = episode(s, args.env_steps)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out, time.perf_counter() - t0

    _, t_first = timed()  # builds the kernels at first use
    (xs, us, _), t_warm = timed()
    m = metrics(args, s, xs, us)
    table_log("receding_mpc", (
        ("success_frac", m["success_frac"], "{:.3f}"),
        ("mean_stage_cost", m["mean_stage_cost"], "{:.4f}"),
        ("final_stage_cost", m["final_stage_cost"], "{:.4f}"),
        ("mean_|du|", m["mean_abs_du"], "{:.4f}"),
        ("ms_per_env_step", 1e3 * t_warm / args.env_steps, "{:.2f}"),
        ("compile_s", t_first - t_warm, "{:.1f}"),
    ))
    if args.out:
        logger = CSVLogger(args.out, ["step", "mean_stage_cost", "mean_abs_u"])
        us_np = us.cpu().numpy()
        for i in range(args.env_steps):
            logger.log(step=i, mean_stage_cost=float(m["stage"][i].mean()), mean_abs_u=float(np.abs(us_np[i]).mean()))
        logger.close()
    return m["success_frac"]


if __name__ == "__main__":
    main()
