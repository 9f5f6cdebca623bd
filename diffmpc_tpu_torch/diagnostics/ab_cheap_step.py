"""A/B on the card: a C++ env's step built as cheap and as dear.

A C++ env's ``kCheapStep`` (``csrc/<env>.cuh``) sets how the kernels spend
a group's lanes. Cheap: the fused solve's groups of 2 and 4 lanes replay the
chosen step (``csrc/ilqr.cuh``, ``ilqr_keeps_lanes``), the line search runs
the ladder's candidates side by side in one pass behind a staging ring that
deepens with the lanes (``csrc/rollout.cuh``, ``rollout_pass_states`` and
``rollout_stages``), and past the lanes' thread budget the rules take 2
lanes for the fused solve and 1 for the line search. Dear: those groups keep
each lane's candidate trajectory, the line search runs rounds of one
candidate a lane behind three slots, and the rules take 1 and 4 lanes
(``ops/cuda/ilqr.py::ilqr_lanes``, ``ops/cuda/rollout.py::rollout_lanes``).

This builds an env's fused-solve and line-search variants a second time
with ``DMPC_FLIP_CHEAP_STEP=1`` (``csrc/variants/variant.cuh``: the other
``kCheapStep``) and, on the same staged inputs, runs both builds at every
built lane count, interleaved:

- the fused solve on the env's own problem at the batches given: the
  acrobot's example (``examples/il_acrobot.py``: T=25, ``lqr_iter=10``,
  ``eps=1e-5``, box +-``max_torque``, starts within 0.08 of upright); the
  cartpole's, the vehicle's and the quadrotor's examples
  (``examples/il_<env>.py``); the slew penalty's wrap of the vehicle, (6,
  2), on the receding example's first solve (``diagnostics/ab_ilqr_lanes.py``,
  its ``VARIANT_CASES``);
- the line search on every call that the non-fused loop (``verbose=1``) of
  the same solve makes (recorded as ``diffmpc_tpu_torch.diagnostics.ab_rollout_lanes``
  records them), for the four zoo envs (the wrap's line search is held to
  one lane by phase 37b's checks and is not timed here).

It reports, per kernel, env and batch, each build's time alone at each lane
count (CUDA events, each one's minimum over the rounds; the line search's
summed over the calls), each build's lane rule's pick and its time, the
share of scenarios bit-equal to the header's build at one lane (raises
below 100%), and the registers and spills ptxas gives each build's kernels.

Run on a machine with a CUDA device:

    python -m diffmpc_tpu_torch.diagnostics.ab_cheap_step [--envs acrobot cartpole vehicle quadrotor passthrough_vehicle] [--batches 1024 16384 65536]

It prints the card's name and power limit, then one JSON record per kernel,
env and batch.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import io
import json
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..csrc import build
from ..models import AcrobotDx
from ..ops.cuda import ilqr as il
from ..ops.cuda import rollout as rol
from .ab_ilqr_lanes import VARIANT_CASES, bit_equal_share, case_model, variant_call
from .ab_rollout_lanes import recorded_calls, time_calls
from .card import interleaved_ms, ptxas_report, require_card

T, LQR_ITER, EPS = 25, 10, 1e-5
FAMILIES = ("ilqr", "rollout")


def starts(B: int, seed: int = 0) -> np.ndarray:
    """Both angles and speeds within 0.08 of upright (examples/common.py's
    acrobot starts)."""
    rng = np.random.default_rng(seed)
    th1, th2 = rng.uniform(-0.08, 0.08, B), rng.uniform(-0.08, 0.08, B)
    return np.stack([np.cos(th1), np.sin(th1), np.cos(th2), np.sin(th2), rng.uniform(-0.08, 0.08, B),
                     rng.uniform(-0.08, 0.08, B)], -1).astype(np.float32)


def problem(B: int, device) -> tuple:
    """``(x_init, C, c, dyn, u_lower, u_upper)``: the acrobot's goal cost
    and box over ``T`` steps."""
    dx = AcrobotDx.default(device=device)
    q, p = dx.get_true_obj()
    box = torch.full((T, B, 1), dx.max_torque, device=device)
    return torch.tensor(starts(B), device=device), torch.diag(q).expand(T, B, 7, 7), p.expand(T, B, 7), dx, -box, box


def build_both(envs: dict, tmp: str) -> tuple:
    """Each env's (``{name: KernelEnv}``) fused-solve and line-search
    variants as the headers have them (the libraries the wrappers load) and
    with the other ``kCheapStep`` (into ``tmp``), all units compiled at once.
    Returns ``({name: {family: {build: CDLL}}}, {name: {build: ptxas
    report}})``; the wrap's line search is not built."""
    keys = {(name, family): il.env_variant_key(env, family) for name, env in envs.items() for family in FAMILIES
            if family == "ilqr" or not env.passthrough}
    # the headers' build through the package's own cache, beside the other
    # (the other at half the nvcc processes of a variant build)
    with ThreadPoolExecutor(max_workers=1) as pool:
        own = pool.submit(build.build_variants, list(keys.values()))
        flipped_libs, flipped_logs = build.build_variants_with(keys.values(), tmp, ("DMPC_FLIP_CHEAP_STEP=1",),
                                                               "flipped", build.variant_workers() // 2)
        built = own.result()
    libs, reports = {}, {}
    for (name, family), key in keys.items():
        libs.setdefault(name, {})[family] = dict(headers=build.load_variant(key), flipped=flipped_libs[key])
    for name in envs:
        mine = [key for (n, _), key in keys.items() if n == name]
        reports[name] = dict(headers=ptxas_report("".join(built[key][1] for key in mine)),
                             flipped=ptxas_report("".join(flipped_logs[key] for key in mine)))
    return libs, reports


_KERNEL_ENV = il.kernel_env


def other_env(dyn) -> il.KernelEnv:
    """``kernel_env`` of ``dyn`` with the other ``cheap_step`` (a wrap's
    inner env read unflipped, inside :func:`flipped` too)."""
    saved, il.kernel_env = il.kernel_env, _KERNEL_ENV
    try:
        env = _KERNEL_ENV(dyn)
    finally:
        il.kernel_env = saved
    return env._replace(cheap_step=not env.cheap_step)


@contextlib.contextmanager
def flipped(libs: dict):
    """While inside (nested too): ``kernel_env`` gives the env the other
    ``cheap_step`` (so that ``run_staged`` sizes the lane scratch for it)
    and the fused solve's launchers come from the other build."""
    saved = il.kernel_env, il.kernel_library
    il.kernel_env, il.kernel_library = other_env, lambda key: libs["ilqr"]["flipped"]
    try:
        yield
    finally:
        il.kernel_env, il.kernel_library = saved


def solve_problem(name: str, B: int, device) -> tuple:
    """``(args, run_staged's knobs)`` of env ``name``'s fused solve at ``B``:
    the acrobot's :func:`problem`, else the recorded solve of
    ``ab_ilqr_lanes.VARIANT_CASES``."""
    if name == "acrobot":
        return problem(B, device), dict(lqr_iter=LQR_ITER, eps=EPS)
    args, knobs, _, _, _ = variant_call(*VARIANT_CASES[name](device, B))
    return args, knobs


def solve_record(device, name: str, B: int, libs: dict, rounds: int, loops: int) -> dict:
    """Both builds of env ``name``'s fused solve at every built lane count on
    one staging of its problem at ``B``."""
    args, knobs = solve_problem(name, B, device)
    env = il.kernel_env(args[3])
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    with flipped(libs):
        other_launch = il._cuda_launcher(device, other_env(args[3]), False)

    def run_other(launch, L):
        with flipped(libs):
            return il.run_staged(launch, *args, lanes=L, **knobs)

    # the headers' build first: the other build's stages (each inside the
    # one before, interleaved_ms) then all run inside its own `flipped`
    stagers = {f"headers/{L}": (il._cuda_launcher(device, env, False),
                                lambda launch, L=L: il.run_staged(launch, *args, lanes=L, **knobs))
               for L in il.ILQR_LANES}
    stagers.update({f"flipped/{L}": (other_launch, lambda launch, L=L: run_other(launch, L)) for L in il.ILQR_LANES})
    outs = {key: stage(launcher) for key, (launcher, stage) in stagers.items()}
    share = {key: bit_equal_share(out, outs["headers/1"]) for key, out in outs.items()}
    ms = interleaved_ms(stagers, rounds, loops)
    pick = dict(headers=il.ilqr_lanes(B, env, sm_count), flipped=il.ilqr_lanes(B, other_env(args[3]), sm_count))
    T = args[1].shape[0]
    return dict(kernel="ilqr", env=name, B=B, T=T, lqr_iter=knobs.get("lqr_iter"), sm_count=sm_count,
                cheap_step=env.cheap_step, pick=pick, pick_ms={b: ms[f"{b}/{L}"] for b, L in pick.items()}, ms=ms,
                bit_equal_share=share, max_n_iters=int(outs["headers/1"].n_iters.max()))


def line_search_record(device, name: str, B: int, libs: dict, rounds: int, loops: int) -> dict:
    """Both builds of env ``name``'s line search and its twin at every built
    lane count on every call of the non-fused loop's solve at ``B``."""
    from .. import MPCConfig, QuadCost, mpc_solve

    if name == "acrobot":
        x0, _, _, dx, _, _ = problem(B, device)
        q, p = dx.get_true_obj()
        config = MPCConfig(n_state=6, n_ctrl=1, T=T, lqr_iter=LQR_ITER, eps=EPS, verbose=1, exit_unconverged=False)
        cost, lo, hi = QuadCost(torch.diag(q), p), -dx.max_torque, dx.max_torque
    else:
        ex = importlib.import_module(f"diffmpc_tpu_torch.examples.il_{name}")
        s = ex.build(ex.parse_args(["--batch", str(B)]), device)
        config = dataclasses.replace(s["config"], verbose=1, exit_unconverged=False)
        x0, cost, dx, lo, hi = s["x_init"], s["cost"], s["dx"], s["lo"], s["hi"]
    calls = []
    with torch.no_grad(), recorded_calls(calls), contextlib.redirect_stdout(io.StringIO()):
        mpc_solve(config, x0, cost, dx, u_lower=lo, u_upper=hi)
    env, other = il.kernel_env(dx), other_env(dx)
    ms, equal, scenarios, _, _ = time_calls(device, calls, libs["rollout"], rounds, loops, rol.ROLLOUT_LANES)
    share = {k: e / scenarios for k, e in equal.items()}
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    pick = dict(headers=rol.rollout_lanes(B, env, sm_count, config.T),
                flipped=rol.rollout_lanes(B, other, sm_count, config.T))
    return dict(kernel="rollout", env=name, B=B, T=config.T, calls=len(calls), sm_count=sm_count,
                cheap_step=env.cheap_step, pick=pick, pick_ms={b: ms[f"rollout/{b}/{L}"] for b, L in pick.items()},
                ms=ms, bit_equal_share=share)


ENVS = ("acrobot", "cartpole", "vehicle", "quadrotor", "passthrough_vehicle")


def run(device, batches, envs=("acrobot",), rounds: int = 3, loops: int = 3):
    """Yield the ptxas record of each env, then one record per kernel, env
    and batch; raises where a build or lane count is not bit for bit the
    headers' build at one lane on every scenario."""
    kenvs = {name: il.kernel_env(case_model(name)[0]) for name in envs}
    with tempfile.TemporaryDirectory() as tmp:
        libs, reports = build_both(kenvs, tmp)
        for name in envs:
            yield dict(kernel="ptxas", env=name, **reports[name])
        for name in envs:
            records = (solve_record,) if kenvs[name].passthrough else (solve_record, line_search_record)
            for B in batches:
                for record in records:
                    rec = record(device, name, B, libs[name], rounds, loops if B <= 16384 else 1)
                    if min(rec["bit_equal_share"].values()) < 1.0:
                        raise AssertionError(f"cheap-step A/B: a build or lane count is not bit for bit one lane: {rec}")
                    yield rec
                    torch.cuda.empty_cache()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", type=int, nargs="+", default=[1024, 16384, 65536])
    parser.add_argument("--envs", nargs="+", choices=ENVS, default=["acrobot"])
    opts = parser.parse_args()
    device = require_card()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    for rec in run(device, opts.batches, opts.envs):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
