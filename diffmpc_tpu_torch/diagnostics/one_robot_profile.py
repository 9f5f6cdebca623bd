"""The card's busy time in one env step of one robot (B=1), profiled in a
process of its own.

For each env named, it builds the render example's problem
(``diffmpc_tpu_torch/examples/render_trajectory.py``, ``build``: B=1, T=15,
``lqr_iter=8``), runs its receding loop to env step ``--at`` and profiles one
more env step under ``torch.profiler``, CUDA events around it. It prints one
JSON line an env: ``busy_ms`` (the device time of the trace's kernels),
``fused_kernel_ms`` (the fused iLQR kernel's share of it), ``kernels`` (the
trace's device events) and ``profiled_env_step_ms``; the card's idle share
is ``1 - busy_ms / profiled_env_step_ms``. It raises where the trace lacks
the fused kernel, since then ``busy_ms`` would leave out the step's
largest piece.

``chip_smoke.py`` phase 41 runs it in a fresh process: late in that
script's long process, the profiler has recorded the step without its fused
kernel, or with no device event at all.

Run on a machine with a CUDA card, from the root of a checkout:

    python -m diffmpc_tpu_torch.diagnostics.one_robot_profile [--envs pendulum cartpole ...] [--at 40]
"""

from __future__ import annotations

import argparse
import json

import torch

from diffmpc_tpu_torch.diagnostics.card import require_card


def profile_env_step(name: str, at: int, device) -> dict:
    """Profile env step ``at`` of env ``name``'s one-robot episode (one
    unprofiled call first, to warm up)."""
    from torch.profiler import ProfilerActivity, profile

    from diffmpc_tpu_torch.examples import render_trajectory as ex
    from diffmpc_tpu_torch.receding import receding_init, receding_step

    s = ex.build(ex.parse_args(["--env", name]), device)
    cfg = s["config"]
    bounds = dict(u_lower=s["lo"], u_upper=s["hi"])
    state = receding_init(cfg, s["x0"])
    with torch.no_grad():
        for _ in range(at):
            state, _ = receding_step(cfg, state, s["cost"], s["dx"], **bounds)

        def step():
            receding_step(cfg, state, s["cost"], s["dx"], **bounds)

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
    fused = [us for kname, us in device_us if "ilqr_kernel" in kname]
    if not fused:
        raise AssertionError(f"{name}: the profiler's trace of env step {at} lacks the fused kernel "
                             f"({len(device_us)} device events)")
    return dict(env=name, at=at, busy_ms=sum(us for _, us in device_us) / 1e3, fused_kernel_ms=sum(fused) / 1e3,
                kernels=len(device_us), profiled_env_step_ms=start.elapsed_time(end))


def main(argv=None) -> list:
    from diffmpc_tpu_torch.examples.render_trajectory import ENVS

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--envs", nargs="+", choices=list(ENVS), default=list(ENVS))
    ap.add_argument("--at", type=int, default=40, help="the env step profiled")
    args = ap.parse_args(argv)
    device = require_card()
    out = []
    for name in args.envs:
        out.append(profile_env_step(name, args.at, device))
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()
