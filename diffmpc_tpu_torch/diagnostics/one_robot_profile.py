"""The card's busy time in one named step, profiled in a process of its own.

Each step is built from the port's own examples and run to where the
profile is taken, then one more step is profiled under ``torch.profiler``
with CUDA events around it:

- ``one_robot``: an env step of the render example's one-robot episode
  (``examples/render_trajectory.py``, ``build``: B=1, T=15, ``lqr_iter=8``)
  at env step ``--at`` (default 40), for each env of ``--envs``;
- ``receding``: an env step of the receding-horizon example
  (``examples/receding_mpc.py``) at env step ``--at`` (default 50), for each
  of ``--runs`` (the example's flags, as one string);
- ``example``: a training step of each example of ``--runs`` (its module and
  flags, as one string), after ``--warm`` steps (default 4), through the
  example's own ``build`` and ``common.make_step``. BASELINE.json config 4's
  training step is il_cartpole's at its defaults (B=4096, Adam 2e-2 on
  ``{"dyn", "logq"}``).

It prints one JSON line a step: ``busy_ms`` (the device time of the trace's
kernels), ``kernel_ms`` (that of each kernel the step must launch),
``kernels`` (the trace's device events), ``profiled_step_ms`` and
``idle_share = 1 - busy_ms / profiled_step_ms``. The step must launch the
fused iLQR kernel (the non-fused loop's Riccati kernel for a model past the
fused gate, as il_nn_dynamics's MLP), and a training step the KKT kernel
too; it raises where the trace lacks one of them, since ``busy_ms`` would
then leave out the step's largest piece. Late in a long process
(``chip_smoke.py``'s) the profiler has recorded steps without their fused
kernel, or with no device event at all; ``chip_smoke.py`` phases 35, 37, 39
and 41 run this in a fresh process.

Run on a machine with a CUDA card, from the root of a checkout:

    python -m diffmpc_tpu_torch.diagnostics.one_robot_profile one_robot [--envs pendulum cartpole ...] [--at 40]
    python -m diffmpc_tpu_torch.diagnostics.one_robot_profile receding --runs "--env pendulum --slew 0"
        "--env vehicle --slew 1 --batch 1024" [--at 50]
    python -m diffmpc_tpu_torch.diagnostics.one_robot_profile example --runs il_cartpole "sysid_domain_rand
        --goal-rand 0.3" [--warm 4]
"""

from __future__ import annotations

import argparse
import importlib
import json
import shlex

import torch

from diffmpc_tpu_torch.diagnostics.card import require_card

# a kernel's name in the trace (its mangled name holds the entry function's)
KERNELS = {"ilqr": "ilqr_kernel", "riccati": "riccati_kernel", "kkt": "kkt_kernel"}


def profile_step(name: str, step, want: tuple) -> dict:
    """``step()`` once to warm up, then once under ``torch.profiler`` with
    CUDA events around it; raises where the trace lacks a kernel of
    ``want`` (KERNELS' keys)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        step()
        end.record()
        end.synchronize()
    device_us = [(e.name, getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_ms = {k: sum(us for kname, us in device_us if KERNELS[k] in kname) / 1e3 for k in want}
    missing = [k for k, ms in kernel_ms.items() if not ms > 0]
    if missing:
        raise AssertionError(f"{name}: the profiler's trace lacks the {', '.join(missing)} kernel "
                             f"({len(device_us)} device events)")
    busy, step_ms = sum(us for _, us in device_us) / 1e3, start.elapsed_time(end)
    return dict(step=name, busy_ms=busy, kernel_ms=kernel_ms, kernels=len(device_us), profiled_step_ms=step_ms,
                idle_share=1 - busy / step_ms)


def one_robot(env: str, at: int, device) -> dict:
    """Env step ``at`` of env ``env``'s one-robot episode."""
    from diffmpc_tpu_torch.examples import render_trajectory as ex
    from diffmpc_tpu_torch.receding import receding_init, receding_step

    s = ex.build(ex.parse_args(["--env", env]), device)
    cfg, bounds = s["config"], dict(u_lower=s["lo"], u_upper=s["hi"])
    state = receding_init(cfg, s["x0"])
    with torch.no_grad():
        for _ in range(at):
            state, _ = receding_step(cfg, state, s["cost"], s["dx"], **bounds)
        out = profile_step(f"one_robot {env}", lambda: receding_step(cfg, state, s["cost"], s["dx"], **bounds),
                           ("ilqr",))
    return dict(out, env=env, at=at)


def receding(run: str, at: int, device) -> dict:
    """Env step ``at`` of the receding example's episode with the flags
    ``run``."""
    from diffmpc_tpu_torch.examples import receding_mpc as ex
    from diffmpc_tpu_torch.receding import receding_init, receding_step

    args = ex.parse_args(shlex.split(run))
    s = ex.build(args, device)
    cfg, bounds = s["config"], dict(u_lower=s["lo"], u_upper=s["hi"])
    state = receding_init(cfg, s["x0"])

    def step():
        return receding_step(cfg, state, s["cost"], s["model"], s["plant"].forward, **bounds)

    with torch.no_grad():
        for _ in range(at):
            state, _ = step()
        out = profile_step(f"receding {run}", step, ("ilqr",))
    return dict(out, receding=run, env=args.env, slew=args.slew, at=at)


def example(run: str, warm: int, device) -> dict:
    """A training step of the example ``run`` (its module and flags) after
    ``warm`` steps."""
    from diffmpc_tpu_torch.examples import common
    from diffmpc_tpu_torch.mpc import _would_use_fused
    from diffmpc_tpu_torch.parallel import generate_expert_data
    from diffmpc_tpu_torch.types import LinDx, QuadCost

    module, *flags = shlex.split(run)
    ex = importlib.import_module(f"diffmpc_tpu_torch.examples.{module}")
    b = ex.build(ex.parse_args(flags), device)
    _, u_expert, _ = generate_expert_data(b["config"], b["cost"], b["dx"], b["x_init"], b["lo"], b["hi"])
    step, state, inputs = common.make_step(ex.parse_args(flags), b, u_expert)
    cost, dx = b["make_problem"](b["params0"], *inputs[2:])
    fused = _would_use_fused(b["config"], dx, is_quad=isinstance(cost, QuadCost), constrained=b["lo"] is not None,
                             is_lin=isinstance(dx, LinDx))
    for _ in range(warm):
        state, _ = step(state, *inputs)
    out = profile_step(f"example {run}", lambda: step(state, *inputs), ("ilqr" if fused else "riccati", "kkt"))
    return dict(out, example=run, warm=warm)


def main(argv=None) -> list:
    from diffmpc_tpu_torch.examples.render_trajectory import ENVS

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="kind", required=True)
    p = sub.add_parser("one_robot")
    p.add_argument("--envs", nargs="+", choices=list(ENVS), default=list(ENVS))
    p.add_argument("--at", type=int, default=40, help="the env step profiled")
    p = sub.add_parser("receding")
    p.add_argument("--runs", nargs="+", required=True, help='the example\'s flags, as "--env vehicle --slew 1"')
    p.add_argument("--at", type=int, default=50, help="the env step profiled")
    p = sub.add_parser("example")
    p.add_argument("--runs", nargs="+", required=True, help='an example and its flags, as "il_vehicle --batch 512"')
    p.add_argument("--warm", type=int, default=4, help="the steps taken before the profiled one")
    args = ap.parse_args(argv)
    device = require_card()
    if args.kind == "one_robot":
        calls = [lambda e=e: one_robot(e, args.at, device) for e in args.envs]
    elif args.kind == "receding":
        calls = [lambda r=r: receding(r, args.at, device) for r in args.runs]
    else:
        calls = [lambda r=r: example(r, args.warm, device) for r in args.runs]
    out = []
    for call in calls:
        out.append(call())
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()
