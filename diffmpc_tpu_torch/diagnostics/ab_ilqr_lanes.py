"""A/B on the card: the fused iLQR kernel at each lane count.

The fused kernel solves each scenario with a group of L threads
(``csrc/ilqr.cuh``: the alpha ladder's rollouts side by side, each step's
slice staged once for the group, the ``hoist_lin`` pre-pass shared out),
L in :data:`~diffmpc_tpu_torch.ops.cuda.ilqr.ILQR_LANES`; the wrapper's
rule (:func:`~diffmpc_tpu_torch.ops.cuda.ilqr.ilqr_lanes`) picks one per
batch. For each shape this runs every built L on the same staged inputs and
reports:

- per L, the share of scenarios whose ``xs``, ``us``, ``objs``, ``n_iters``
  and ``alpha`` equal the L = 1 kernel's bit for bit (every L computes the
  same float32 operations on the same values, so 100% is the design; it
  raises below that);
- per L, the kernel's time alone (CUDA events around launches on staged
  inputs, the L's interleaved in each round, each one's minimum kept), and
  the rule's pick with its time over L = 1's.

The shapes: the pendulum swing-up of the main path (T=20, ``lqr_iter=10``,
``eps=1e-5``) and the JAX bench's learned-dynamics cell (its 3-16-16-3 MLP,
residual, tanh, swing-up starts; T=15, ``lqr_iter=8``; ``bench.py:592-624``)
with and without ``hoist_lin``, at the batches given.

With ``--variants`` it runs the fused kernel's variants instead (the
kernels built at first use, ``csrc/variants/ilqr.cu``), each on the inputs
that its own path gives it, recorded from one ``mpc_solve`` (:data:`VARIANT_CASES`):
the slewed receding loop's first solve (the passthrough pendulum and
vehicle, B=1024), the (6, 3) MLP of ``scripts/ab_pnqp_enum3.py`` under
``pnqp_enum`` "" and "1", config 4's cartpole (B=4096), the vehicle,
quadrotor and acrobot examples (B=1024), one robot of each zoo env at env
step 40 of the render example's episode (B=1), and the pendulum with the
simplified value update; with ``--wide`` each zoo and passthrough env's
example problem again at the batches given (by default 16,384 and 65,536,
where the lane rule's budget binds; ``--wide-only`` skips the cases' own
widths). For each it reports every L's time and bit-equal share as above, the
rule's pick, and each L's registers, local memory, shared memory a block
and blocks an SM as the card gives them (``diffmpc_ilqr_variant_occupancy``).
``--parent DIR`` times another checkout's build of the same variant, or
without ``--variants`` its prebuilt kernels (``DIR``, a tree unpacked by
``git archive``; its own ``csrc/build.py`` builds them into its own
``_build``) in the same rounds, its bits reported against this checkout's
one lane and not held; ``--profile`` builds each
variant again with ``-DDMPC_ILQR_PROFILE`` (``csrc/ilqr.cuh``,
``IlqrProfile``) and reports each L's cycles by phase, summed over the
groups' first lanes, and their shares.

Run on a machine with a CUDA device:

    python -m diffmpc_tpu_torch.diagnostics.ab_ilqr_lanes [--batches 1024 65536] [--parent DIR]
    python -m diffmpc_tpu_torch.diagnostics.ab_ilqr_lanes --variants [CASE ...] [--wide [B ...]] [--wide-only]
        [--parent DIR] [--profile]

It prints the card's name and power limit, then one JSON record per shape.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib
import json
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..csrc import build
from ..models import NNDynamics, PendulumDx
from ..ops.cuda import ilqr as il
from .card import interleaved_ms, require_card

PEND_T, PEND_ITER = 20, 10
NN_T, NN_ITER, NN_HIDDEN = 15, 8, (16, 16)
EPS = 1e-5


def swing_up_starts(B: int, seed: int = 0) -> np.ndarray:
    """Random angle, speed in [-1, 1]: the main path's initial states."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, B)
    return np.stack([np.cos(th), np.sin(th), rng.uniform(-1.0, 1.0, B)], -1).astype(np.float32)


def problem(dyn, B: int, T: int, device) -> tuple:
    """``(x_init, C, c, dyn, u_lower, u_upper)``: the pendulum's goal cost,
    box +-2, over ``T`` steps."""
    q, p = PendulumDx.default(device=device).get_true_obj()
    box = torch.full((T, B, 1), 2.0, device=device)
    x = torch.tensor(swing_up_starts(B), device=device)
    return x, torch.diag(q).expand(T, B, 4, 4), p.expand(T, B, 4), dyn, -box, box


def bench_mlp(device, seed: int = 0) -> NNDynamics:
    """The JAX bench's MLP with He-normal weights from ``seed``."""
    return NNDynamics.init(3, 1, hidden=NN_HIDDEN, residual=True, device=device,
                           generator=torch.Generator(device=device).manual_seed(seed))


def shapes(device, batches=(1024, 1000, 65536), nn_batches=(1024, 65536)) -> list:
    """``(label, args, knobs, hoist_lin)`` for the pendulum at ``batches``
    and the bench's MLP at ``nn_batches``, without and with ``hoist_lin``."""
    out = []
    pend = PendulumDx.default(device=device)
    for B in batches:
        out.append(("pendulum", problem(pend, B, PEND_T, device), dict(lqr_iter=PEND_ITER, eps=EPS), False))
    nn = bench_mlp(device)
    for B in nn_batches:
        for hoist in (False, True):
            out.append(("mlp_3_16_16_3", problem(nn, B, NN_T, device), dict(lqr_iter=NN_ITER, eps=EPS), hoist))
    return out


def bit_equal_share(got: il.FusedSolveResult, ref: il.FusedSolveResult) -> float:
    """The share of scenarios whose xs, us, objs, n_iters and alpha equal
    ``ref``'s bit for bit."""
    same = torch.ones_like(ref.objs, dtype=torch.bool)
    for f in ("xs", "us"):
        same &= (getattr(got, f) == getattr(ref, f)).all(dim=2).all(dim=0)
    for f in ("objs", "n_iters", "alpha"):
        same &= getattr(got, f) == getattr(ref, f)
    return float(same.float().mean())


def run(device, cases: list, rounds: int = 3, loops: int = 3, lanes=il.ILQR_LANES, parent=None) -> list:
    """One record per case of :func:`shapes`; raises where an L is not bit
    for bit the L = 1 kernel on every scenario. ``parent``: another
    checkout's prebuilt library, whose kernels run beside at the same L's
    (``parent_ms``), their bits reported against this checkout's one lane
    and not held."""
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    records = []
    for label, args, knobs, hoist in cases:
        env = il.kernel_env(args[3])
        T, B = args[1].shape[:2]
        stagers = {
            L: (il._cuda_launcher(device, env, hoist),
                lambda launch, L=L: il.run_staged(launch, *args, hoist_lin=hoist, lanes=L, **knobs))
            for L in lanes
        }
        if parent is not None:
            symbol = f"diffmpc_ilqr_solve_{env.symbol}" + ("_hoist" if hoist else "")
            stagers.update({f"parent/{L}": (library_launcher(parent, env, hoist, symbol),
                                            lambda launch, L=L: il.run_staged(launch, *args, hoist_lin=hoist, lanes=L,
                                                                              **knobs))
                            for L in lanes})
        outs = {L: stage(launcher) for L, (launcher, stage) in stagers.items()}
        share = {L: bit_equal_share(outs[L], outs[1]) for L in lanes}
        ms = interleaved_ms(stagers, rounds, loops if B <= 4096 else max(1, loops // 2))
        pick = il.ilqr_lanes(B, env, sm_count, hoist)
        records.append(dict(
            env=label, B=B, T=T, hoist_lin=hoist, **knobs, sm_count=sm_count, pick=pick,
            bit_equal_share=share, ms={L: ms[L] for L in lanes},
            pick_over_one=ms[pick] / ms[1] if pick in ms else None, max_n_iters=int(outs[1].n_iters.max()),
        ))
        if parent is not None:
            records[-1].update(parent_ms={L: ms[f"parent/{L}"] for L in lanes},
                               parent_bit_equal_share={L: bit_equal_share(outs[f"parent/{L}"], outs[1]) for L in lanes},
                               pick_over_parent=ms[pick] / ms[f"parent/{pick}"])
        if min(share.values()) < 1.0:
            raise AssertionError(f"lanes A/B: a lane count is not bit for bit one lane: {records[-1]}")
        del outs
        torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------------------------
# The variants: each on the inputs its own path gives it.
# ---------------------------------------------------------------------------

# the (6, 3) MLP's problem (scripts/ab_pnqp_enum3.py; chip_smoke's phase 31)
NN63_N, NN63_M, NN63_HIDDEN, NN63_T, NN63_BOX = 6, 3, (16, 16), 20, 0.5
WIDE_BATCHES = (16384, 65536)
PROFILE_PHASES = ("initial rollout", "linearization", "sweep loads", "sweep arithmetic", "ladder",
                  "keep or replay", "bookkeeping")


@contextlib.contextmanager
def recorded_fused(calls: list):
    """Record the fused solve's inputs of every ``mpc_solve`` run inside:
    ``(args, kwargs)`` as ``mpc.py`` gives them to ``ilqr_solve_fused``."""
    from .. import mpc

    saved = mpc.ilqr_solve_fused

    def call(*args, **kw):
        calls.append((args, kw))
        return saved(*args, **kw)

    mpc.ilqr_solve_fused = call
    try:
        yield calls
    finally:
        mpc.ilqr_solve_fused = saved


def _example(name: str, device, B: int = 0) -> tuple:
    """The fused solve's inputs of the true model's solve of example
    ``il_<name>`` at ``B`` (its default width for 0)."""
    from .. import mpc_solve

    ex = importlib.import_module(f"diffmpc_tpu_torch.examples.il_{name}")
    s = ex.build(ex.parse_args(["--batch", str(B)] if B else []), device)
    calls = []
    with torch.no_grad(), recorded_fused(calls):
        mpc_solve(s["config"], s["x_init"], s["cost"], s["dx"], u_lower=s["lo"], u_upper=s["hi"])
    return calls[0]


def _receding(name: str, device, B: int = 1024) -> tuple:
    """The first solve of the receding example's slewed episode (slew 1.0,
    plant error 0.15) of env ``name`` at ``B``."""
    from ..examples import receding_mpc as ex

    s = ex.build(ex.parse_args(["--env", name, "--batch", str(B), "--plant-param-error", "0.15", "--slew", "1.0"]),
                 device)
    calls = []
    with recorded_fused(calls):
        ex.episode(s, 1)
    return calls[0]


def _one_robot(name: str, device, at: int = 40) -> tuple:
    """The solve of env step ``at`` of the render example's episode (B=1)."""
    from ..examples import render_trajectory as ex

    s = ex.build(ex.parse_args(["--env", name]), device)
    calls = []
    with recorded_fused(calls):
        ex.episode(s, at + 1)
    return calls[at]


def _nn63(device, enum: str, B: int = 1024) -> tuple:
    """The (6, 3) MLP's solve at ``B``: C = diag(1 x 6, 0.02 x 3), c = (0 x
    6, 0.08 x 3), x0 ~ U(-0.8, 0.8) from seed 1, box +-0.5, T=20, ten
    iterations, ``pnqp_enum`` ``enum``."""
    nm = NN63_N + NN63_M
    nn = NNDynamics.init(NN63_N, NN63_M, hidden=NN63_HIDDEN, residual=True, device=device,
                         generator=torch.Generator(device=device).manual_seed(0))
    x0 = torch.tensor(np.random.default_rng(1).uniform(-0.8, 0.8, (B, NN63_N)), dtype=torch.float32, device=device)
    C = torch.diag(torch.tensor([1.0] * NN63_N + [0.02] * NN63_M, device=device)).expand(NN63_T, B, nm, nm)
    c = torch.tensor([0.0] * NN63_N + [0.08] * NN63_M, device=device).expand(NN63_T, B, nm)
    box = torch.full((NN63_T, B, NN63_M), NN63_BOX, device=device)
    return (x0, C, c, nn, -box, box), dict(lqr_iter=10, eps=1e-5, pnqp_enum=enum)


def _pendulum_exact(device, B: int = 1024) -> tuple:
    """The headline's pendulum (T=20, ten iterations) with the simplified
    value update (``value_update_exact_reg=1e-6``): the pendulum's variant."""
    return problem(PendulumDx.default(device=device), B, PEND_T, device), dict(
        lqr_iter=PEND_ITER, eps=EPS, value_update_exact_reg=1e-6)


def case_model(case: str):
    """``(model, pnqp_enum, value_update_exact_reg)`` of case ``case`` on
    the CPU: what its variant's key is made of."""
    from .. import models
    from ..models import CtrlPassthroughDynamics

    def models_by_env(name):
        return getattr(models, f"{name.capitalize()}Dx").default(device="cpu")

    if case.startswith("passthrough_"):
        inner = models_by_env(case.split("_", 1)[1])
        return CtrlPassthroughDynamics(inner=inner, n_ctrl=inner.n_ctrl), "", -1.0
    if case.startswith("nn63"):
        nn = NNDynamics.init(NN63_N, NN63_M, hidden=NN63_HIDDEN, residual=True, device="cpu")
        return nn, "1" if case.endswith("enum1") else "", -1.0
    if case == "pendulum_exact":
        return PendulumDx.default(device="cpu"), "", 1e-6
    return models_by_env(case.rsplit("_", 1)[-1]), "", -1.0


def case_key(case: str):
    """The variant key of case ``case``."""
    model, enum, exact_reg = case_model(case)
    env = il.kernel_env(model)
    return il.env_variant_key(env, "ilqr", il.pnqp_enum_flag(env.m, enum),
                              il.fused_exact_update(env.m, 1e-9, exact_reg, enum))


# case -> its inputs' maker (device, B) -> (args, kwargs); B 0 is the case's own width
VARIANT_CASES = {
    "passthrough_vehicle": lambda d, B: _receding("vehicle", d, B or 1024),
    "passthrough_pendulum": lambda d, B: _receding("pendulum", d, B or 1024),
    "nn63": lambda d, B: _nn63(d, "", B or 1024),
    "nn63_enum1": lambda d, B: _nn63(d, "1", B or 1024),
    "cartpole": lambda d, B: _example("cartpole", d, B),
    "vehicle": lambda d, B: _example("vehicle", d, B),
    "quadrotor": lambda d, B: _example("quadrotor", d, B),
    "acrobot": lambda d, B: _example("acrobot", d, B),
    "one_robot_cartpole": lambda d, B: _one_robot("cartpole", d),
    "one_robot_vehicle": lambda d, B: _one_robot("vehicle", d),
    "one_robot_quadrotor": lambda d, B: _one_robot("quadrotor", d),
    "one_robot_acrobot": lambda d, B: _one_robot("acrobot", d),
    "pendulum_exact": lambda d, B: _pendulum_exact(d, B or 1024),
}
# the cases run again at WIDE_BATCHES with --wide
WIDE_CASES = ("passthrough_vehicle", "passthrough_pendulum", "cartpole", "vehicle", "quadrotor", "acrobot")

# ilqr_solve_fused's keywords that run_staged takes
_STAGED_KNOBS = ("u_init", "lqr_iter", "pnqp_iter", "reg", "decay", "max_linesearch_iter", "delta_u", "eps",
                 "best_cost_eps", "not_improved_lim", "hoist_lin", "unroll")


def variant_call(args, kw) -> tuple:
    """``(args, run_staged's knobs, the variant's key, pnqp_enum, exact)`` of
    a recorded fused solve."""
    x0, C = args[0], args[1]
    enum, reg = kw.get("pnqp_enum", ""), kw.get("reg", 1e-9)
    exact = il.fused_exact_update(C.shape[-1] - x0.shape[-1], reg, kw.get("value_update_exact_reg", -1.0), enum)
    env = il.kernel_env(args[3])
    key = il.env_variant_key(env, "ilqr", il.pnqp_enum_flag(env.m, enum), exact)
    if key is None:
        raise ValueError(f"{type(args[3]).__name__} with these flags runs a prebuilt kernel, not a variant")
    return tuple(args[:6]), {k: kw[k] for k in _STAGED_KNOBS if k in kw}, key, enum, exact


def library_launcher(lib, env: il.KernelEnv, hoist: bool, symbol: str = ""):
    """``run_staged``'s launcher for a library ``lib`` (this checkout's or
    another's): its ``symbol``, by default a variant's, counted nowhere;
    raises on a failed launch."""
    fn = getattr(lib, symbol or "diffmpc_ilqr_solve_variant" + ("_hoist" if hoist else ""))
    fn.argtypes = [ctypes.POINTER(il._IlqrArgs), ctypes.POINTER(type(env.struct)), ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(args, env_ref):
        err = fn(args, env_ref, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"variant launch at {args._obj.lanes} lanes failed: cudaError {err}")

    return launch


def parent_libraries(parent: str, keys) -> dict:
    """Another checkout's builds of the variants ``keys`` (its own
    ``csrc/build.py``, into its own ``_build``, all units at once):
    ``{key: CDLL}``."""
    from .ab_kkt_lanes import load_tree

    tree_build = load_tree(parent, "csrc.build")
    built = tree_build.build_variants([tree_build.VariantKey(*key) for key in keys])
    return {key: ctypes.CDLL(built[tree_build.VariantKey(*key)][0]) for key in keys}


def occupancy(lib, lanes, hoist: bool) -> dict:
    """Each L's registers, local memory a thread, shared memory a block and
    blocks an SM, as the card gives them for the variant library ``lib``."""
    query = lib.diffmpc_ilqr_variant_occupancy
    query.argtypes, query.restype = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    out = {}
    for L in lanes:
        v = (ctypes.c_int * 4)()
        if query(L, int(hoist), v) != 0:
            raise RuntimeError(f"the occupancy query at {L} lanes failed")
        out[L] = dict(registers=v[0], local_bytes=v[1], smem_block_bytes=v[2], blocks_per_sm=v[3])
    return out


def profile_variant(lib, env, args, knobs, lanes) -> dict:
    """Each L's cycles by phase (:data:`PROFILE_PHASES`) over one launch of
    the variant's profile build ``lib`` (``DMPC_ILQR_PROFILE``), summed over
    the groups' first lanes, with their shares and the scenarios counted."""
    launch = library_launcher(lib, env, knobs.get("hoist_lin", False))
    out = {}
    for L in lanes:
        read = getattr(lib, f"diffmpc_ilqr_profile_l{L}")
        read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
        cycles = (ctypes.c_ulonglong * (len(PROFILE_PHASES) + 1))()
        read(cycles)  # cleared
        il.run_staged(launch, *args, lanes=L, **knobs)
        torch.cuda.synchronize()
        if read(cycles) != 0:
            raise RuntimeError("reading the profile build's cycles failed")
        total = sum(cycles[:len(PROFILE_PHASES)])
        out[L] = dict(scenarios=cycles[len(PROFILE_PHASES)],
                      cycles={p: cycles[i] for i, p in enumerate(PROFILE_PHASES)},
                      shares={p: cycles[i] / total for i, p in enumerate(PROFILE_PHASES)} if total else None)
    return out


def variant_record(device, case: str, B: int, parent=None, profile_lib=None, rounds: int = 3, loops: int = 3,
                   lanes=il.ILQR_LANES) -> dict:
    """One record of case ``case`` at ``B`` (its own width for 0); raises
    where an L of this checkout is not bit for bit its one lane. ``parent``:
    the other checkout's library of the case's key; ``profile_lib``: this
    checkout's profile build of it."""
    args, knobs, key, enum, exact = variant_call(*VARIANT_CASES[case](device, B))
    env, hoist = il.kernel_env(args[3]), knobs.get("hoist_lin", False)
    T, B = args[1].shape[:2]
    lib = build.load_variant(key)
    builds = {"change": lib}
    if parent is not None:
        builds["parent"] = parent
    stagers = {}
    for name, blib in builds.items():
        for L in lanes:
            stagers[f"{name}/{L}"] = (library_launcher(blib, env, hoist),
                                      lambda launch, L=L: il.run_staged(launch, *args, lanes=L, **knobs))
    outs = {name: stage(launcher) for name, (launcher, stage) in stagers.items()}
    share = {name: bit_equal_share(out, outs["change/1"]) for name, out in outs.items()}
    ms = interleaved_ms(stagers, rounds, loops if B <= 4096 else 1)
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    pick = il.ilqr_lanes(B, env, sm_count, hoist)
    rec = dict(case=case, key=key.name, B=B, T=T, **{k: v for k, v in knobs.items() if k != "u_init"},
               warm=knobs.get("u_init") is not None, pnqp_enum=enum, exact=exact, sm_count=sm_count, pick=pick,
               bit_equal_share=share, ms=ms, pick_ms={name: ms[f"{name}/{pick}"] for name in builds},
               max_n_iters=int(outs["change/1"].n_iters.max()), occupancy=occupancy(lib, lanes, hoist))
    if parent is not None:
        rec["change_over_parent_at_pick"] = ms[f"change/{pick}"] / ms[f"parent/{pick}"]
        rec["parent_occupancy"] = occupancy(parent, lanes, hoist) if hasattr(
            parent, "diffmpc_ilqr_variant_occupancy") else None
    if profile_lib is not None:
        rec["profile"] = profile_variant(profile_lib, env, args, knobs, lanes)
    held = [v for name, v in share.items() if name.startswith("change/")]
    if min(held) < 1.0:
        raise AssertionError(f"variant lanes A/B: a lane count is not bit for bit one lane: {rec}")
    return rec


def run_variants(device, cases, wide=(), parent=None, profiled: bool = False, rounds: int = 3, own: bool = True):
    """Yield :func:`variant_record` of each case at its own width (``own``),
    then of each of :data:`WIDE_CASES` among them at the batches ``wide``.
    Every variant is built first, all units at once: this checkout's, the
    other checkout's and the profile builds side by side."""
    keys = {case: case_key(case) for case in cases}
    unique = list(dict.fromkeys(keys.values()))
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(max_workers=3) as pool:
        t0 = time.perf_counter()
        mine = pool.submit(build.build_variants, unique)
        other = pool.submit(parent_libraries, parent, unique) if parent else None
        prof = pool.submit(build.build_variants_with, unique, tmp, ("DMPC_ILQR_PROFILE=1",), "profile") \
            if profiled else None
        mine.result()
        parents = other.result() if other else {}
        profiles = prof.result()[0] if prof else {}
        yield dict(build_seconds=time.perf_counter() - t0, keys=[key.name for key in unique])
        for case in cases if own else ():
            yield variant_record(device, case, 0, parents.get(keys[case]), profiles.get(keys[case]), rounds)
            torch.cuda.empty_cache()
        for case in (c for c in cases if c in WIDE_CASES):
            for B in wide:
                yield variant_record(device, case, B, parents.get(keys[case]), None, rounds)
                torch.cuda.empty_cache()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", type=int, nargs="+", default=[1024, 1000, 65536])
    parser.add_argument("--nn-batches", type=int, nargs="+", default=[1024, 65536])
    parser.add_argument("--variants", nargs="*", choices=list(VARIANT_CASES), default=None,
                        help="run the variants' cases instead (all of them without names)")
    parser.add_argument("--wide", type=int, nargs="*", default=None,
                        help="the zoo and passthrough cases again at these batches (16,384 and 65,536 without any)")
    parser.add_argument("--wide-only", action="store_true", help="skip the cases at their own widths")
    parser.add_argument("--parent", help="the root of another checkout whose variants run beside")
    parser.add_argument("--profile", action="store_true", help="each L's cycles by phase from a profile build")
    parser.add_argument("--rounds", type=int, default=3)
    opts = parser.parse_args()
    device = require_card()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    if opts.variants is not None:
        cases = opts.variants or list(VARIANT_CASES)
        wide = () if opts.wide is None else opts.wide or WIDE_BATCHES
        records = run_variants(device, cases, wide, opts.parent, opts.profile, opts.rounds, not opts.wide_only)
    else:
        parent = None
        if opts.parent:
            from .ab_kkt_lanes import load_tree

            parent = ctypes.CDLL(load_tree(opts.parent, "csrc.build").build()[0])
        records = run(device, shapes(device, opts.batches, opts.nn_batches), rounds=opts.rounds, parent=parent)
    for rec in records:
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
