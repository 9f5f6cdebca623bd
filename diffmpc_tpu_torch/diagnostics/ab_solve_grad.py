"""A/B on the card: ``mpc_solve`` with and without the gradient, across trees.

Times the main path's solve (the pendulum, goal cost, box +-2, T=20,
``lqr_iter=10``, B=1024: chip_smoke's phase 8) and the JAX bench's
learned-dynamics cell (its 3-16-16-3 MLP, T=15, ``lqr_iter=8``, B=1024:
phase 25), each forward alone and with the gradient of ``mean(us**2)``
with respect to the model's parameters, in strict alternation, best of
each, by CUDA events. With ``--cells config2`` it times BASELINE.json
config 2 instead (``LinDx`` n=4, m=2, box +-0.6; T=20 at ``lqr_iter`` 10
and T=128 at 20, as chip_smoke's phases 12 and 18 run it) at B=128, 4096
and 65,536, the forward alone and with the gradient of ``mean(us**2)`` with
respect to c, in strict alternation. It also reads the card's busy time for one
call of each from ``torch.profiler`` (the sum of the kernels' device time)
and gives the rest of the call's time as the card's idle share. With
``--cells host`` it times the host-bound steps of chip_smoke's phases 7, 37
and 39: the imitation step of ``make_dp_train_step`` at B=1024 (phase 7's
recipe, 40 steps, each read back as phase 7 reads its loss), the pendulum's
receding episode of ``examples/receding_mpc.py`` at B=1024 (100 env steps,
+-15% plant error, its second run by CUDA events) and ``il_pendulum``'s
step at its default widths (the median ``dt`` of its ``train.csv``, steps
2-12).

Each tree (a checkout of the repository) runs in its own process that
imports ``diffmpc_tpu_torch`` from that tree, in the order given and then in
reverse (parent, change, change, parent for two trees), so that a drift of
the card or the host shows as a difference between a tree's two runs; with
``--pairs N``, N such rounds, the order turned round each time, and
``--only`` keeps the named config 2 cells (``config2_T20_B4096``, ...).
With ``--one-lane`` the last tree runs once more, in the middle, with the
fused kernel's lane rule held at one lane (``ops/cuda/ilqr.py``,
``ilqr_lanes``), to tell the kernel's part from the host's.

Run on a machine with a CUDA device, from the root of a checkout:

    python diffmpc_tpu_torch/diagnostics/ab_solve_grad.py --trees PARENT . [--one-lane] [--cells config2|host]
        [--pairs N] [--only CELL ...]

It prints the card's name and power limit, one JSON record per process,
and a summary: each label's best and median time over its processes.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

PEND_B, PEND_T, PEND_ITER, PEND_LOOPS, PEND_ROUNDS = 1024, 20, 10, 20, 5
NN_B, NN_T, NN_ITER, NN_LOOPS, NN_ROUNDS = 1024, 15, 8, 5, 3
CONFIG2_BATCHES, CONFIG2_ITERS, CONFIG2_BOX = (128, 4096, 65536), {20: 10, 128: 20}, 0.6
IL_STEPS, RH_STEPS = 40, 100  # phase 7's imitation steps, phase 37's env steps
EPS = 1e-5


def swing_up_starts(B: int, seed: int):
    """Random angle, speed in [-1, 1] (chip_smoke's ``x_init``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, B)
    return np.stack([np.cos(th), np.sin(th), rng.uniform(-1.0, 1.0, B)], -1).astype(np.float32)


def busy_ms(fn):
    """The card's busy time in one call of ``fn``: the kernels' device time
    summed from ``torch.profiler``, or None where it records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            total += getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)
    return total / 1e3 if total > 0 else None


def measure_config2(device="cuda", only=None) -> dict:
    """Config 2's forward and forward + gradient in this process's tree at
    each horizon and batch (those named in ``only``, where given), best of
    three rounds in strict alternation, each the mean of a few solves."""
    import torch

    from diffmpc_tpu_torch import LinDx, MPCConfig, QuadCost, mpc_solve
    from diffmpc_tpu_torch.diagnostics.card import cuda_ms

    def config2_problem(T, B, seed):
        """tests/oracles.py's random LQR problem at config 2's widths, drawn
        on the card (as diagnostics/ab_rollout_lanes.py draws it)."""
        g = torch.Generator(device=device).manual_seed(seed)
        L = torch.randn((T, B, 6, 6), generator=g, device=device)
        C = L @ L.transpose(-1, -2) / 6 + 0.5 * torch.eye(6, device=device)
        c = torch.randn((T, B, 6), generator=g, device=device)
        F = torch.randn((T, B, 4, 6), generator=g, device=device) * 0.5
        f = torch.randn((T, B, 4), generator=g, device=device) * 0.5
        return C, c, F, f, torch.randn((B, 4), generator=g, device=device)

    device = torch.device(device)
    out = {}
    for T, iters in CONFIG2_ITERS.items():
        config = MPCConfig(n_state=4, n_ctrl=2, T=T, lqr_iter=iters, exit_unconverged=False,
                           detach_unconverged=False)
        for B in CONFIG2_BATCHES:
            if only and f"config2_T{T}_B{B}" not in only:
                continue
            C, c, F, f, x0 = config2_problem(T, B, seed=2000 + B)

            def fwd():
                with torch.no_grad():
                    return mpc_solve(config, x0, QuadCost(C, c), LinDx(F, f), u_lower=-CONFIG2_BOX,
                                     u_upper=CONFIG2_BOX)

            c_leaf = c.clone().requires_grad_(True)

            def fwd_grad():
                us = mpc_solve(config, x0, QuadCost(C, c_leaf), LinDx(F, f), u_lower=-CONFIG2_BOX,
                               u_upper=CONFIG2_BOX).us
                torch.autograd.grad(us.pow(2).mean(), c_leaf)

            n_iters = int(fwd().info.n_iters)
            loops = 3 if B < 65536 else 2
            t_f = t_g = float("inf")
            for _ in range(3):  # strict alternation, best of each
                t_f = min(t_f, cuda_ms(fwd, loops, 1))
                t_g = min(t_g, cuda_ms(fwd_grad, loops, 1))
            b_f = busy_ms(fwd)
            out[f"config2_T{T}_B{B}"] = dict(fwd_ms=t_f, solve_plus_grad_ms=t_g, grad_extra_ms=t_g - t_f,
                                             n_iters=n_iters, fwd_busy_ms=b_f,
                                             fwd_idle_share=None if b_f is None else 1 - b_f / t_f)
            del C, c, F, f, x0
            torch.cuda.empty_cache()
    return out


def measure_host(device="cuda") -> dict:
    """The host-bound steps of chip_smoke's phases 7, 37 and 39 (module
    docstring) in this process's tree."""
    import csv
    import functools
    import tempfile

    import torch

    from diffmpc_tpu_torch import MPCConfig, QuadCost
    from diffmpc_tpu_torch.examples import il_pendulum, receding_mpc
    from diffmpc_tpu_torch.models import PendulumDx
    from diffmpc_tpu_torch.parallel import generate_expert_data, init_train_state, make_dp_train_step

    device = torch.device(device)
    dx = PendulumDx.default(device=device)
    q, p = dx.get_true_obj()
    cost = QuadCost(torch.diag(q), p)
    config = MPCConfig(n_state=3, n_ctrl=1, T=PEND_T, lqr_iter=PEND_ITER, eps=EPS, exit_unconverged=False,
                       detach_unconverged=True)
    x = torch.tensor(swing_up_starts(PEND_B, 0), device=device)
    _, u_expert, _ = generate_expert_data(config, cost, dx, x, -2.0, 2.0)
    adam = functools.partial(torch.optim.Adam, lr=5e-2)
    step = make_dp_train_step(config, lambda prm: (cost, dx.replace(params=prm)), adam, None, -2.0, 2.0)
    state = init_train_state(torch.tensor((8.0, 1.25, 0.8), device=device), adam)
    for _ in range(3):
        state, stats = step(state, x, u_expert)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(IL_STEPS):
        state, stats = step(state, x, u_expert)
        float(stats.loss)
    torch.cuda.synchronize()
    out = dict(il_step=dict(step_ms=(time.perf_counter() - t0) / IL_STEPS * 1e3))

    args = receding_mpc.parse_args(["--batch", str(PEND_B), "--env-steps", str(RH_STEPS), "--plant-param-error",
                                    "0.15", "--seed", "0"])
    s = receding_mpc.build(args, device)
    receding_mpc.episode(s, RH_STEPS)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    receding_mpc.episode(s, RH_STEPS)
    end.record()
    end.synchronize()
    out["receding_pendulum"] = dict(env_step_ms=start.elapsed_time(end) / RH_STEPS)

    with tempfile.TemporaryDirectory() as tmp:
        il_pendulum.main(["--steps", "12", "--ckpt-every", "0", "--out", tmp])
        with open(os.path.join(tmp, "train.csv")) as f:
            dts = [float(row["dt"]) for row in csv.DictReader(f)][1:]
    out["il_pendulum"] = dict(step_ms=statistics.median(dts) * 1e3)
    return out


def measure(one_lane: bool, device="cuda") -> dict:
    """Both cells' forward and forward + gradient in this process's tree."""
    import dataclasses

    import torch

    from diffmpc_tpu_torch import MPCConfig, QuadCost, mpc_solve
    from diffmpc_tpu_torch.diagnostics.card import cuda_ms
    from diffmpc_tpu_torch.models import NNDynamics, PendulumDx
    from diffmpc_tpu_torch.ops.cuda import ilqr as il

    if one_lane:
        il.ilqr_lanes = lambda *args, **kwargs: 1
    device = torch.device(device)
    dx = PendulumDx.default(device=device)
    q, p = dx.get_true_obj()
    cost = QuadCost(torch.diag(q), p)
    out = {}

    def cell(name, config, model_of, leaves, B, seed, loops, rounds):
        grad_config = dataclasses.replace(config, detach_unconverged=False)
        x = torch.tensor(swing_up_starts(B, seed), device=device)
        model = model_of(leaves)

        def fwd():
            with torch.no_grad():
                mpc_solve(config, x, cost, model, u_lower=-2.0, u_upper=2.0)

        def fwd_grad():
            us = mpc_solve(grad_config, x, cost, model, u_lower=-2.0, u_upper=2.0).us
            torch.autograd.grad(us.pow(2).mean(), leaves)

        t_f = t_g = float("inf")
        for _ in range(rounds):  # strict alternation, best of each
            t_f = min(t_f, cuda_ms(fwd, loops, 1))
            t_g = min(t_g, cuda_ms(fwd_grad, loops, 1))
        b_f, b_g = busy_ms(fwd), busy_ms(fwd_grad)
        out[name] = dict(
            fwd_ms=t_f, solve_plus_grad_ms=t_g, grad_extra_ms=t_g - t_f, fwd_busy_ms=b_f, grad_busy_ms=b_g,
            fwd_idle_share=None if b_f is None else 1 - b_f / t_f,
            grad_idle_share=None if b_g is None else 1 - b_g / t_g,
            lanes=il.ilqr_solve_fused.__dict__.get("last_lanes"),
        )

    pend_config = MPCConfig(n_state=3, n_ctrl=1, T=PEND_T, lqr_iter=PEND_ITER, eps=EPS,
                            exit_unconverged=False, detach_unconverged=False)
    prm = [dx.params.clone().requires_grad_(True)]
    cell("pendulum", pend_config, lambda ls: dx.replace(params=ls[0]), prm, PEND_B, 21, PEND_LOOPS, PEND_ROUNDS)

    nn = NNDynamics.init(3, 1, hidden=(16, 16), residual=True, device=device,
                         generator=torch.Generator(device=device).manual_seed(0))
    k = len(nn.weights)
    nn_config = MPCConfig(n_state=3, n_ctrl=1, T=NN_T, lqr_iter=NN_ITER, eps=EPS,
                          exit_unconverged=False, detach_unconverged=False)
    leaves = [a.clone().requires_grad_(True) for a in nn.weights + nn.biases]
    cell("nn_3_16_16_3", nn_config, lambda ls: nn.replace(weights=tuple(ls[:k]), biases=tuple(ls[k:])), leaves,
         NN_B, 7, NN_LOOPS, NN_ROUNDS)
    return out


def child(tree: str, one_lane: bool, cells: str, only) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import diffmpc_tpu_torch

    here = os.path.dirname(os.path.abspath(diffmpc_tpu_torch.__file__))
    if os.path.dirname(here) != os.path.abspath(tree):
        raise RuntimeError(f"imported diffmpc_tpu_torch from {here}, not from {tree}")
    rec = (measure_config2(only=only) if cells == "config2" else measure_host() if cells == "host"
           else measure(one_lane))
    print(json.dumps(rec), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trees", nargs="+", required=True, help="checkouts of the repository, parent first")
    parser.add_argument("--one-lane", action="store_true", help="also run the last tree at one lane")
    parser.add_argument("--cells", choices=("main", "config2", "host"), default="main",
                        help="the main path and the MLP, config 2 (each solve and gradient), or the host-bound steps")
    parser.add_argument("--pairs", type=int, default=2, help="rounds over the trees, the order turned round each")
    parser.add_argument("--only", nargs="*", help="the config 2 cells to time (default all)")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    parser.add_argument("--child-one-lane", action="store_true", help=argparse.SUPPRESS)
    opts = parser.parse_args()
    if opts.child:
        child(opts.child, opts.child_one_lane, opts.cells, opts.only)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    runs = [(tree, False) for tree in opts.trees]
    middle = [(opts.trees[-1], True)] * 2 if opts.one_lane else []
    order = []
    for i in range(opts.pairs):
        order += (runs if i % 2 == 0 else runs[::-1]) + (middle if i == 0 else [])
    times = {}
    for tree, one_lane in order:
        label = os.path.basename(os.path.abspath(tree)) + (":one_lane" if one_lane else "")
        cmd = [sys.executable, os.path.abspath(__file__), "--trees", tree, "--child", tree, "--cells", opts.cells,
               *(["--only", *opts.only] if opts.only else [])]
        proc = subprocess.run(cmd + (["--child-one-lane"] if one_lane else []), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{label} failed (exit {proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(dict(label=label, tree=tree, **rec)), flush=True)
        for cell, r in rec.items():
            for key in ("fwd_ms", "solve_plus_grad_ms", "step_ms", "env_step_ms"):
                if key in r:
                    times.setdefault(label, {}).setdefault(cell, {}).setdefault(key, []).append(r[key])
    summary = {label: {cell: {key: min(ts) for key, ts in keys.items()} for cell, keys in cells.items()}
               for label, cells in times.items()}
    medians = {label: {cell: {key: statistics.median(ts) for key, ts in keys.items()} for cell, keys in cells.items()}
               for label, cells in times.items()}
    print(json.dumps(dict(summary=summary, median=medians, runs=times)), flush=True)


if __name__ == "__main__":
    main()
