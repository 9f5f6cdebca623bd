"""Build, inspect and run ahead-of-time solve artifacts (the deployment workflow).

Build host (the card, or the CPU with ``--cpu``; ``--target cuda`` writes
the card's artifact from a CPU build):
    python -m diffmpc_tpu_torch.examples.export_artifact build --env pendulum --batch 1024 --out solve.bin
    python -m diffmpc_tpu_torch.examples.export_artifact build --cpu --target cuda --out solve.bin
Fleet side (the manifest alone, without loading the program):
    python -m diffmpc_tpu_torch.examples.export_artifact inspect solve.bin
Serving host (loads without the config and model code of ``build``):
    python -m diffmpc_tpu_torch.examples.export_artifact run solve.bin --reps 20

The port's counterpart of ``examples/export_artifact.py``: the artifact holds
config, cost, dynamics, bounds and batch size
(:func:`diffmpc_tpu_torch.aot.export_solve`). ``--warm-start`` adds the
``u_init`` runtime input (receding-horizon serving); ``--params-input``
leaves the dynamics parameters a runtime input (a learned model served
without exporting again). ``run`` prints the ms per batch: on the card by
CUDA events, on the CPU by the host's clock.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from diffmpc_tpu_torch import MPCConfig, QuadCost
from diffmpc_tpu_torch.aot import export_solve, load_solve, read_manifest
from diffmpc_tpu_torch.examples.common import (
    pick_device,
    random_acrobot_x_init,
    random_cartpole_x_init,
    random_pendulum_x_init,
    random_vehicle_x_init,
)
from diffmpc_tpu_torch.examples.il_quadrotor import random_quadrotor_x_init
from diffmpc_tpu_torch.models import AcrobotDx, CartpoleDx, PendulumDx, QuadrotorDx, VehicleDx


def _quadrotor_x_init(B, seed=0, dtype=torch.float32, device="cpu"):
    """The JAX script's starts: positions in [-0.5, 0.5], the rest in [-0.2, 0.2]."""
    return random_quadrotor_x_init(B, seed, dtype, device, scale=0.5)


# name -> (cls, n, m, (lo, hi) scalars or per-dim lists, x_init generator)
ENVS = {
    "pendulum": (PendulumDx, 3, 1, (-2.0, 2.0), random_pendulum_x_init),
    "cartpole": (CartpoleDx, 5, 1, (-10.0, 10.0), random_cartpole_x_init),
    "quadrotor": (QuadrotorDx, 6, 2, (0.0, 5.0), _quadrotor_x_init),
    "acrobot": (AcrobotDx, 6, 1, (-4.0, 4.0), random_acrobot_x_init),
    "vehicle": (VehicleDx, 4, 2, ([-6.0, -0.5], [3.0, 0.5]), random_vehicle_x_init),  # an asymmetric mixed box
}
STARTS = {cls.__name__: gen for cls, _, _, _, gen in ENVS.values()}


def problem(env: str, horizon: int, lqr_iter: int, device):
    """``(config, cost, dx, lo, hi)`` of ``env`` on ``device``: the goal cost
    of its ``get_true_obj`` and its box."""
    cls, n, m, (lo, hi), _ = ENVS[env]
    if isinstance(lo, list):
        lo, hi = torch.tensor(lo, device=device), torch.tensor(hi, device=device)
    dx = cls.default(device=device)
    q, p = dx.get_true_obj()
    config = MPCConfig(n_state=n, n_ctrl=m, T=horizon, lqr_iter=lqr_iter, eps=1e-5, exit_unconverged=False,
                       detach_unconverged=False)
    return config, QuadCost(torch.diag(q), p), dx, lo, hi


def build(args) -> bytes:
    config, cost, dx, lo, hi = problem(args.env, args.horizon, args.lqr_iter, pick_device(args, "build"))
    t0 = time.perf_counter()
    blob = export_solve(config, cost, dx, args.batch, u_lower=lo, u_upper=hi, warm_start=args.warm_start,
                        params_input=args.params_input, vjp_order=args.vjp_order,
                        platforms=[args.target] if args.target else None)
    with open(args.out, "wb") as f:
        f.write(blob)
    m = read_manifest(blob)
    print(f"wrote {args.out}: {len(blob) / 1e6:.3f} MB in {time.perf_counter() - t0:.1f}s (env={args.env} "
          f"B={args.batch} T={args.horizon} target={m['platforms'][0]} warm_start={args.warm_start} "
          f"params_input={args.params_input} vjp_order={args.vjp_order})")
    return blob


def inspect_artifact(args) -> dict:
    """Print the manifest without loading the program: the fleet-side check."""
    m = read_manifest(open(args.artifact, "rb").read())
    if m is None:
        raise SystemExit("a raw payload without a manifest: no self-description; build it again")
    print(json.dumps(m, indent=2, sort_keys=True))
    return m


def _inputs(manifest: dict, seed: int, params, device) -> list:
    """The runtime inputs of the manifest: the dynamics' starts (its class
    name picks the generator), a cold ``u_init`` and the ``params`` given."""
    B = manifest["inputs"][0]["shape"][0]
    gen = STARTS.get(manifest["dynamics"])
    if gen is None:
        raise SystemExit(f"no start generator for {manifest['dynamics']}")
    inputs = [gen(B, seed, torch.float32, device)]
    for spec in manifest["inputs"][1:]:
        if spec["name"] == "u_init":
            inputs.append(torch.zeros(spec["shape"], device=device))
        else:  # the model's params cannot be guessed (zeros are zero masses)
            if params is None:
                raise SystemExit(f"the artifact takes params: pass --params v1,v2,... for {spec['leaves']}")
            vals = torch.tensor([float(v) for v in params.split(",")], device=device)
            inputs.append([vals.expand(leaf["shape"]).contiguous() for leaf in spec["leaves"]])
    return inputs


def run(args) -> dict:
    """Load the artifact, call it once, then time ``--reps`` calls."""
    blob = open(args.artifact, "rb").read()
    solve = load_solve(blob)
    m = solve.manifest
    if m is None:
        raise SystemExit("a raw payload without a manifest: its inputs are unknown; build it again")
    device = torch.device(m["platforms"][0])
    print(f"artifact platforms={m['platforms']} inputs={m['input_names']} "
          f"shapes={[i.get('shape') for i in m['inputs']]} dynamics={m['dynamics']}")
    inputs = _inputs(m, args.seed, args.params, device)
    t0 = time.perf_counter()
    sol = solve(*inputs)
    print(f"first call {time.perf_counter() - t0:.2f}s; mean obj {float(sol.objs.mean()):.4f}, converged "
          f"{float(sol.info.converged.float().mean()):.2f}")
    B = inputs[0].shape[0]
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            solve(*inputs)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / args.reps
        print(f"{ms:.3f} ms/batch on {torch.cuda.get_device_name(device)} by CUDA events "
              f"({B / ms * 1e3:,.0f} solves/s)")
    else:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            solve(*inputs)
        ms = (time.perf_counter() - t0) / args.reps * 1e3
        print(f"{ms:.3f} ms/batch on the CPU (host clock)")
    return dict(ms=ms, objs=sol.objs, converged=sol.info.converged)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build", help="export an artifact")
    b.add_argument("--env", choices=sorted(ENVS), default="pendulum")
    b.add_argument("--batch", type=int, default=1024)
    b.add_argument("--horizon", type=int, default=20)
    b.add_argument("--lqr-iter", type=int, default=10)
    b.add_argument("--target", choices=("cpu", "cuda"), default=None,
                   help="the platform of the artifact (default: the build's device)")
    b.add_argument("--warm-start", action="store_true")
    b.add_argument("--params-input", action="store_true")
    b.add_argument("--vjp-order", type=int, default=0)
    b.add_argument("--cpu", action="store_true", help="build from CPU tensors")
    b.add_argument("--out", default="solve.bin")
    b.set_defaults(fn=build)
    i = sub.add_parser("inspect", help="print the manifest (the program is not loaded)")
    i.add_argument("artifact")
    i.set_defaults(fn=inspect_artifact)
    r = sub.add_parser("run", help="load and time an artifact")
    r.add_argument("artifact")
    r.add_argument("--reps", type=int, default=20)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--params", default=None, help="comma-separated dynamics params for --params-input artifacts")
    r.set_defaults(fn=run)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
