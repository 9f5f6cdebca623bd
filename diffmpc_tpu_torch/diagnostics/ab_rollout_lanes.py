"""A/B on the card: the line-search rollout kernels at each lane count.

The resident line search (``csrc/rollout.cu``) and its streaming twin
(``csrc/rollout_stream.cu``) run each scenario with a group of L threads
(``csrc/rollout.cuh``: the ladder's candidates shared out over the lanes,
``ceil(10 / L)`` a lane in one pass over the horizon for a cheap step, one a
lane and a round of L a pass for an MLP's; the pick a ballot, each lane's
first candidate's trajectory kept), L in
:data:`~diffmpc_tpu_torch.ops.cuda.rollout.ROLLOUT_LANES`; the wrappers' rule
(:func:`~diffmpc_tpu_torch.ops.cuda.rollout.rollout_lanes`) picks one per
batch. The two kernels differ only in where a group reads a step's slice
for an MLP's step: from device memory (the resident kernel) or from shared
memory, where the group stages it once (the twin); for a cheap step both
stage it.

The inputs are the ones ``mpc_solve`` gives the line search: every call of
a solve, recorded (the kernel the dispatch took answers it meanwhile), so
that the first iterations, where the full step mostly improves, and the last
ones, where converged scenarios improve on no candidate, weigh as they do in
a solve. For each shape this stages each recorded call once and runs, on
the same staged inputs, both kernels at every built L, and with ``other``
also a second build of the same sources with those preprocessor defines
(by default ``DMPC_ROLLOUT_FLIP_PASSES``: each env takes the other choice
of ``rollout_pass_states``, rounds of one candidate a lane for a cheap step,
the ladder in one pass for an MLP's; ``DMPC_ROLLOUT_STAGES=3`` gives every
group a staging ring of three slots). It reports:

- per kernel, build and L, the share of scenarios whose ``xs``, ``us``,
  ``objs``, ``alpha`` and ``improved`` equal the resident kernel's at L = 1
  bit for bit over every call (the design gives 100%; it raises below that);
- per kernel, build and L, the time alone summed over the calls (CUDA
  events around launches on the staged inputs, the variants interleaved in
  each round, each one's minimum kept), the rule's pick and its time over
  L = 1's;
- the calls' share of scenarios whose full step improved, and whose ladder
  improved at all.

The shapes: BASELINE.json config 2 (``LinDx`` n=4, m=2, box +-0.6,
``lqr_iter`` 10 at T=20 and 20 at T=128) at the batches given; the
pendulum's step (``FINITE_DIFF``) at T=20 (the resident kernel) at the MLP
batches and at T=256, B=1024 (the twin); the JAX
bench's 3-16-16-3 MLP (``bench.py:592-624``) with ``verbose=1`` at T=15
(the resident kernel) and T=128 (the twin, its last layer scaled by 0.1) at
the MLP batches given.

With ``--variants`` it runs instead the variants' cases (:data:`VARIANT_CASES`),
each on the line searches its own path records: the zoo's envs with
``verbose=1`` at their examples' problems (T=20, B=1024; the cartpole also at
T=128, the twin), the slew penalty's wrapped pendulum and vehicle at the
receding example's width (T=20 and 128), and a (6, 3) ``LinDx`` box-DDP at
B=4096 (config 2's recipe). Each record adds the share of scenarios that no
candidate improved (``1 - mean improved``) per call and the share that the
replay takes at the rule's lane count; with ``--parent DIR`` the same
variants of another checkout (its own ``csrc/build.py``) in the same rounds,
not held to bit-equality; with ``--profile`` each lane count's cycles by
phase from a build with ``DMPC_ROLLOUT_PROFILE`` (``rollout.cuh``,
``RolloutProfile``); with ``--ptxas`` each key's registers, stack frame and
spill bytes (``-Xptxas -v``) and the local loads and stores of each kernel's
SASS (``cuobjdump -sass``). Without ``--variants``, ``--parent`` builds the
other checkout's prebuilt rollout sources and times them beside.

Run on a machine with a CUDA device:

    python -m diffmpc_tpu_torch.diagnostics.ab_rollout_lanes [--batches 128 4096] [--other DEFINE=VALUE ...]
        [--parent DIR]
    python -m diffmpc_tpu_torch.diagnostics.ab_rollout_lanes --variants [CASE ...] [--parent DIR] [--profile]
        [--ptxas]

It prints the card's name and power limit, then one JSON record per shape.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import glob
import importlib
import io
import json
import os
import re
import shutil
import subprocess
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor

import torch

from ..csrc import build
from ..models import PendulumDx
from ..ops.cuda import rollout as rol
from .ab_ilqr_lanes import bench_mlp, problem
from .card import require_card

KINDS = ("rollout", "rollout_stream")
CONFIG2_N, CONFIG2_M, CONFIG2_BOX = 4, 2, 0.6
CONFIG2_ITERS = {20: 10, 128: 20}
PEND_T, PEND_B, PEND_ITER = 256, 1024, 10  # the twin's pendulum shape
NN_SHAPES = {15: (8, 1.0), 128: (4, 0.1)}  # T: (lqr_iter, scale of the last layer)
NN_RECORD_B = 1024


def build_other(tmp: str, defines, csrc: str = build.CSRC, label: str = "rollout_other") -> ctypes.CDLL:
    """The rollout kernels built from the sources of ``csrc`` (this
    checkout's or another's) with the preprocessor ``defines``
    (``NAME=VALUE``; one nvcc per source, in parallel)."""
    names = ["rollout.cu", "rollout_stream.cu"] + [os.path.basename(p) for p in
                                                   glob.glob(os.path.join(csrc, "rollout_nn_l*.cu"))]
    return build.build_with([os.path.join(csrc, name) for name in names], tmp, defines, label)


@contextlib.contextmanager
def recorded_calls(calls: list):
    """Record every line search ``mpc_solve`` runs (both kernels' entry
    points as the dispatch in ``ops/lqr.py`` calls them): the inputs that
    change from call to call cloned, the rest by reference."""
    from ..ops import lqr

    saved = {name: getattr(lqr, name) for name in ("linesearch_rollout_cuda", "linesearch_rollout_stream_cuda")}

    def recorder(name):
        def call(*args, **kw):
            calls.append((name, [a.clone() if i >= 5 and a is not None else a for i, a in enumerate(args)], kw))
            return saved[name](*args, **kw)

        return call

    for name in saved:
        setattr(lqr, name, recorder(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(lqr, name, fn)


def config2_problem(T: int, B: int, device, seed: int, n: int = CONFIG2_N, m: int = CONFIG2_M):
    """tests/oracles.py's random LQR problem (PSD cost L L'/nm + 0.5 I) at
    config 2's widths (or at ``(n, m)``, F scaled by sqrt(4 / n) so that its
    open-loop growth is config 2's), drawn on the card: C, c, F, f,
    x_init."""
    g = torch.Generator(device=device).manual_seed(seed)
    nm = n + m
    L = torch.randn((T, B, nm, nm), generator=g, device=device)
    C = L @ L.transpose(-1, -2) / nm + 0.5 * torch.eye(nm, device=device)
    c = torch.randn((T, B, nm), generator=g, device=device)
    F = torch.randn((T, B, n, nm), generator=g, device=device) * (0.5 * (CONFIG2_N / n) ** 0.5)
    f = torch.randn((T, B, n), generator=g, device=device) * 0.5
    return C, c, F, f, torch.randn((B, n), generator=g, device=device)


def tiled(calls: list, reps: int) -> list:
    """``calls`` with every batch-major input repeated ``reps`` times along
    the batch: the same line searches for ``reps`` times the scenarios."""
    def tile(a, dim):
        shape = [1] * a.ndim
        shape[dim] = reps
        return a.repeat(*shape)

    out = []
    for kind, args, kw in calls:
        B = args[0].shape[0]  # x_init (B, n); the rest (T, B, ...)
        out.append((kind, [None if a is None else tile(a, 0 if i == 0 else 1) for i, a in enumerate(args)],
                    {k: tile(v, 1) if torch.is_tensor(v) and v.ndim == 3 and v.shape[1] == B else v
                     for k, v in kw.items()}))
    return out


def record(case: str, T: int, B: int, device) -> list:
    """The line searches of one ``mpc_solve`` of ``case`` at ``(T, B)``:
    ``[(kind the dispatch took, args, kwargs), ...]``. The MLP's are
    recorded at B=1024 and tiled to ``B``: the non-fused loop's
    linearization of the MLP (``torch.func``) needs more than the card's
    memory at T=128, B=65,536."""
    from .. import GradMethods, LinDx, MPCConfig, QuadCost, mpc_solve

    if case == "mlp_3_16_16_3" and B > NN_RECORD_B:
        return tiled(record(case, T, NN_RECORD_B, device), -(-B // NN_RECORD_B))
    calls = []
    with torch.no_grad(), recorded_calls(calls), contextlib.redirect_stdout(io.StringIO()):
        if case == "config2":
            C, c, F, f, x0 = config2_problem(T, B, device, seed=T + B)
            cfg = MPCConfig(n_state=CONFIG2_N, n_ctrl=CONFIG2_M, T=T, lqr_iter=CONFIG2_ITERS[T],
                            exit_unconverged=False, detach_unconverged=False)
            mpc_solve(cfg, x0, QuadCost(C, c), LinDx(F, f), u_lower=-CONFIG2_BOX, u_upper=CONFIG2_BOX)
        else:
            if case == "pendulum":
                dyn, iters, kw = PendulumDx.default(device=device), PEND_ITER, dict(grad_method=GradMethods.FINITE_DIFF)
            else:
                iters, scale = NN_SHAPES[T]
                dyn = bench_mlp(device)
                dyn = dyn.replace(weights=dyn.weights[:-1] + (dyn.weights[-1] * scale,))
                kw = dict(verbose=1)
            x0, C, c, dyn, _, _ = problem(dyn, B, T, device)
            cfg = MPCConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=iters, eps=1e-5, exit_unconverged=False,
                            detach_unconverged=False, **kw)
            mpc_solve(cfg, x0, QuadCost(C[0, 0], c[0, 0]), dyn, u_lower=-2.0, u_upper=2.0)
    return calls


def shapes(batches=(128, 4096, 16384, 65536), nn_batches=(1024, 65536)) -> list:
    """``(case, T, B)``: config 2 at T=20 and T=128 at ``batches``, the
    pendulum at T=20 at ``nn_batches`` and at T=256, the bench MLP at T=15
    and T=128 at ``nn_batches``."""
    out = [("config2", T, B) for T in (20, 128) for B in batches]
    out += [("pendulum", 20, B) for B in nn_batches] + [("pendulum", PEND_T, PEND_B)]
    out += [("mlp_3_16_16_3", T, B) for T in NN_SHAPES for B in nn_batches]
    return out


def same_scenarios(got: rol.LineSearchResult, ref: rol.LineSearchResult) -> torch.Tensor:
    """Per scenario: xs, us, objs, alpha and improved equal ``ref``'s bit
    for bit."""
    same = torch.ones_like(ref.objs, dtype=torch.bool)
    for f in ("xs", "us"):
        same &= (getattr(got, f) == getattr(ref, f)).all(dim=2).all(dim=0)
    for f in ("objs", "alpha", "improved"):
        same &= getattr(got, f) == getattr(ref, f)
    return same


def time_calls(device, calls: list, libs: dict, rounds: int, loops: int, lanes, kinds=KINDS, refs=None) -> tuple:
    """Stage each call once; on its inputs launch every (kernel of ``kinds``,
    build, L; a build's library None: the one the wrapper loads), check it
    against the first kernel at L = 1 of the first build, and time it alone,
    interleaved. Returns ``(ms summed over the calls, scenarios bit-equal
    summed, the calls' scenarios, full-step and any-step improvement
    counts)``, the first two keyed ``kind/build/L``; appends each call's
    reference result to ``refs`` where given."""
    variants = [(kind, name, L) for name in libs for kind in kinds for L in lanes]
    ms = {v: 0.0 for v in variants}
    equal = {v: 0 for v in variants}
    scenarios = full_step = improved = 0
    counted = types.SimpleNamespace(launches=0, last_lanes=None)
    for _, args, kw in calls:
        T, B, m, n = args[5].shape
        staged = rol.stage_rollout(*args, lanes=max(lanes), **kw)
        env_ref = None if staged.env is None else ctypes.byref(staged.env)
        launches = {}
        for kind, name, L in variants:
            a = rol._RolloutArgs.from_buffer_copy(staged.args)
            a.lanes = L
            if not rol.rollout_keeps_lane_trajectories(L):
                a.lane_x = a.lane_u = None
            launch = rol._cuda_launcher(device, n, m, kw.get("dyn"), kind, counted, libs[name])
            launches[(kind, name, L)] = (launch, a)
        ref = None
        for v, (launch, a) in launches.items():
            launch(ctypes.byref(a), n, m, env_ref)
            got = staged.result()
            if ref is None:
                ref = rol.LineSearchResult(*(t.clone() for t in got))
            equal[v] += int(same_scenarios(got, ref).sum())
        scenarios += B
        full_step += int((ref.improved & (ref.alpha == 1.0)).sum())
        improved += int(ref.improved.sum())
        if refs is not None:
            refs.append(ref)
        torch.cuda.synchronize()
        best = {}
        for _ in range(rounds):
            for v, (launch, a) in launches.items():
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(loops):
                    launch(ctypes.byref(a), n, m, env_ref)
                end.record()
                end.synchronize()
                best[v] = min(best.get(v, float("inf")), start.elapsed_time(end) / loops)
        for v in variants:
            ms[v] += best[v]
        del staged, launches, ref
    key = lambda v: "/".join(map(str, v))  # noqa: E731
    return ({key(v): t for v, t in ms.items()}, {key(v): e for v, e in equal.items()}, scenarios, full_step, improved)


def held_shares(share: dict) -> dict:
    """The bit-equal shares that are held: every build's but another
    checkout's (``/parent/``)."""
    return {v: sh for v, sh in share.items() if "/parent/" not in v}


def run(device, cases: list, other=(), rounds: int = 2, loops: int = 3,
        lanes=rol.ROLLOUT_LANES, parent=None):
    """Yield one record per ``(case, T, B)`` of :func:`shapes`; raises
    where a kernel, build or L of this checkout is not bit for bit the
    resident kernel at L = 1 on every scenario of every call. ``parent``:
    the root of another checkout whose prebuilt rollout kernels run beside
    (reported, not held)."""
    from ..ops.cuda.ilqr import kernel_env

    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    libs = {"policy": build.load()}
    with tempfile.TemporaryDirectory() as tmp:
        if other:
            libs["other"] = build_other(tmp, other)
        if parent:
            libs["parent"] = build_other(tmp, (), os.path.join(parent, "diffmpc_tpu_torch", "csrc"), "rollout_parent")
        for case, T, B in cases:
            calls = record(case, T, B, device)
            dyn = calls[0][2].get("dyn")
            env = None if dyn is None else kernel_env(dyn)
            ms, equal, scenarios, full_step, improved = time_calls(
                device, calls, libs, rounds, loops if B <= 16384 else max(1, loops // 2), lanes)
            share = {v: e / scenarios for v, e in equal.items()}
            pick = rol.rollout_lanes(B, env, sm_count, T)
            record_ = dict(
                case=case, T=T, B=B, calls=len(calls), dispatched=sorted({k for k, _, _ in calls}), other=list(other),
                sm_count=sm_count, pick=pick, full_step_share=full_step / scenarios,
                improved_share=improved / scenarios, bit_equal_share=share, ms=ms,
                pick_over_one={k: ms[f"{k}/policy/{pick}"] / ms[f"{k}/policy/1"] for k in KINDS},
                pick_over_parent={k: ms[f"{k}/policy/{pick}"] / ms[f"{k}/parent/{pick}"] for k in KINDS}
                if parent else None,
            )
            del calls
            torch.cuda.empty_cache()
            if min(held_shares(share).values()) < 1.0:
                raise AssertionError(f"rollout lanes A/B: a variant is not bit for bit one lane: {record_}")
            yield record_


# ---------------------------------------------------------------------------
# The variants: each on the line searches its own path records.
# ---------------------------------------------------------------------------

ZOO_LS_B, RECEDING_B, LINDX63_B = 1024, 1024, 4096
LONG_T = 128
PROFILE_PHASES = ("start", "copies issued", "wait and sync", "control", "stage cost", "baseline's cost", "env step",
                  "pick", "kept slot's copy", "replay")


def _zoo_calls(name: str, T: int, device) -> list:
    """The line searches of env ``name``'s ``verbose=1`` solve (the non-fused
    loop) at its example's problem, B=1024, with the learner's first params,
    over ``T`` steps."""
    from .. import mpc_solve

    ex = importlib.import_module(f"diffmpc_tpu_torch.examples.il_{name}")
    s = ex.build(ex.parse_args(["--seed", "0", "--batch", str(ZOO_LS_B)]), device)
    cfg = dataclasses.replace(s["config"], T=T, verbose=1, detach_unconverged=False)
    prm = s["params0"]["dyn"] if name == "cartpole" else torch.exp(s["params0"])
    calls = []
    with torch.no_grad(), recorded_calls(calls), contextlib.redirect_stdout(io.StringIO()):
        mpc_solve(cfg, s["x_init"], s["cost"], s["dx"].replace(params=prm), u_lower=s["lo"], u_upper=s["hi"])
    return calls


def _receding_calls(name: str, T: int, device) -> list:
    """The line searches of the receding example's slewed (1.0) ``verbose=1``
    solve of env ``name`` (the wrapped step) at its full width over ``T``
    steps, the previous control 0.1."""
    from .. import mpc_solve
    from ..examples import receding_mpc as ex

    s = ex.build(ex.parse_args(["--env", name, "--batch", str(RECEDING_B), "--horizon", "20", "--lqr-iter", "10",
                                "--seed", "0", "--plant-param-error", "0.15", "--slew", "1.0"]), device)
    cfg = dataclasses.replace(s["config"], T=T, verbose=1)
    calls = []
    with torch.no_grad(), recorded_calls(calls), contextlib.redirect_stdout(io.StringIO()):
        mpc_solve(cfg, s["x0"], s["cost"], s["model"], u_lower=s["lo"], u_upper=s["hi"],
                  prev_ctrl=torch.full((RECEDING_B, s["config"].n_ctrl), 0.1, device=device))
    return calls


def _lindx63_calls(device) -> list:
    """The line searches of a (6, 3) LinDx box-DDP solve (config 2's recipe
    at (6, 3), box +-0.6, T=20, ten iterations) at B=4096."""
    from .. import LinDx, MPCConfig, QuadCost, mpc_solve

    C, c, F, f, x0 = config2_problem(20, LINDX63_B, device, seed=33, n=6, m=3)
    cfg = MPCConfig(n_state=6, n_ctrl=3, T=20, lqr_iter=10, exit_unconverged=False, detach_unconverged=False)
    calls = []
    with torch.no_grad(), recorded_calls(calls), contextlib.redirect_stdout(io.StringIO()):
        mpc_solve(cfg, x0, QuadCost(C, c), LinDx(F, f), u_lower=-CONFIG2_BOX, u_upper=CONFIG2_BOX)
    return calls


# case -> its recorded line searches (device -> calls)
VARIANT_CASES = {
    **{name: (lambda d, name=name: _zoo_calls(name, 20, d)) for name in ("cartpole", "vehicle", "quadrotor", "acrobot")},
    "cartpole_T128": lambda d: _zoo_calls("cartpole", LONG_T, d),
    "passthrough_pendulum": lambda d: _receding_calls("pendulum", 20, d),
    "passthrough_vehicle": lambda d: _receding_calls("vehicle", 20, d),
    "passthrough_pendulum_T128": lambda d: _receding_calls("pendulum", LONG_T, d),
    "passthrough_vehicle_T128": lambda d: _receding_calls("vehicle", LONG_T, d),
    "lindx63": _lindx63_calls,
}


def call_key(call):
    """The variant key of a recorded line search, or None for a prebuilt
    kernel."""
    from ..ops.cuda.ilqr import env_variant_key, kernel_env, kernel_variant_key

    _, args, kw = call
    dyn = kw.get("dyn")
    if dyn is None:
        T, B, m, n = args[5].shape
        return kernel_variant_key("rollout", n, m)
    return env_variant_key(kernel_env(dyn), "rollout")


def ladder(n_alpha: int, decay: float) -> torch.Tensor:
    """The rolled ladder's steps, one float32 product at a time."""
    out = torch.ones(n_alpha, dtype=torch.float32)
    for k in range(1, n_alpha):
        out[k] = out[k - 1] * decay
    return out


def replay_shares(refs: list, lanes: int, cheap: bool, n_alpha: int = 10, decay: float = 0.2) -> dict:
    """Per call, the share of scenarios no candidate improved (1 - mean
    improved) and the share whose trajectory is no lane's first candidate at
    ``lanes`` lanes (a cheap step's ceil(n_alpha / L) candidates a lane), so
    that keeping each lane's first candidate alone leaves it to a replay;
    and whether the rolled ladder's last step equals alpha_floor bit for
    bit."""
    steps = ladder(n_alpha, decay)
    per = -(-n_alpha // lanes) if cheap else 1
    none, replayed = [], []
    for ref in refs:
        alpha = ref.alpha.detach().float().cpu()
        k = (alpha[:, None] == steps[None, :]).float().argmax(1)
        improved = ref.improved.cpu()
        state = (k % (lanes * per)) // lanes
        none.append(float(1.0 - improved.float().mean()))
        replayed.append(float((~improved | (state > 0)).float().mean()))
    floor = torch.tensor(decay ** (n_alpha - 1), dtype=torch.float32)
    return dict(none_improved=none, replayed_at_pick=replayed, mean_none_improved=sum(none) / len(none),
                mean_replayed_at_pick=sum(replayed) / len(replayed),
                rolled_last_step_is_floor=bool(steps[-1].view(torch.int32) == floor.view(torch.int32)))


def sass_local_accesses(path: str) -> dict:
    """``{kernel: {"LDL": count, "STL": count}}`` over the SASS of every
    kernel of the library ``path`` (``cuobjdump -sass``, from nvcc's
    directory), demangled by ``c++filt`` where it is installed."""
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True, check=True, timeout=600).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            out[fn] = {"LDL": 0, "STL": 0}
        elif fn is not None:
            for op in ("LDL", "STL"):
                if re.search(rf"\b{op}\b", line):
                    out[fn][op] += 1
    filt = shutil.which("c++filt")
    if filt and out:
        names = subprocess.run([filt], input="\n".join(out), capture_output=True, text=True, timeout=60).stdout.split("\n")
        out = dict(zip(names, out.values()))
    return out


def ptxas_and_sass(keys, tmp: str) -> dict:
    """Each variant key's ptxas report (registers, stack frame, spill bytes
    per kernel, from a build of its units with ``-Xptxas -v``) and the local
    loads and stores of its kernels' SASS."""
    from .card import ptxas_report

    built = build.build_variants(keys)
    logs = {key: log for key, (_, log) in built.items()}
    stale = [key for key, log in logs.items() if not log]
    if stale:  # built before this process: build again for the log
        logs.update(build.build_variants_with(stale, tmp, (), "ptxas")[1])
    out = {}
    for key in keys:
        report = ptxas_report(logs[key], "rollout_kernel")
        out[key.name] = dict(ptxas=report, sass=sass_local_accesses(built[key][0]))
    return out


def profile_calls(device, lib, calls: list, lanes) -> dict:
    """Each L's cycles by phase (:data:`PROFILE_PHASES`) summed over one launch
    of each call of the profile build ``lib`` (``DMPC_ROLLOUT_PROFILE``),
    over the groups' first lanes, with their shares and the scenarios
    counted."""
    counted = types.SimpleNamespace(launches=0, last_lanes=None)
    out = {}
    for L in lanes:
        read = getattr(lib, f"diffmpc_rollout_profile_l{L}")
        read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
        cycles = (ctypes.c_ulonglong * (len(PROFILE_PHASES) + 1))()
        read(cycles)  # cleared
        for kind, args, kw in calls:
            T, B, m, n = args[5].shape
            launch = rol._cuda_launcher(device, n, m, kw.get("dyn"), _kind(kind), counted, lib)
            rol.run_staged_rollout(launch, *args, lanes=L, **{k: v for k, v in kw.items() if k != "use_cuda"})
        torch.cuda.synchronize()
        if read(cycles) != 0:
            raise RuntimeError("reading the profile build's cycles failed")
        total = sum(cycles[:len(PROFILE_PHASES)])
        out[L] = dict(scenarios=cycles[len(PROFILE_PHASES)], cycles={p: cycles[i] for i, p in enumerate(PROFILE_PHASES)},
                      shares={p: cycles[i] / total for i, p in enumerate(PROFILE_PHASES)} if total else None)
    return out


def _kind(recorded: str) -> str:
    """The kernel kind of a recorded entry point's name."""
    return "rollout_stream" if "stream" in recorded else "rollout"


def run_variants(device, cases, parent=None, profiled: bool = False, ptxas: bool = False, rounds: int = 3,
                 loops: int = 3, lanes=rol.ROLLOUT_LANES):
    """Yield a record of each variant case: its recorded calls through the
    kernel the dispatch took at every L (this checkout's, held bit-equal to
    one lane, and ``parent``'s, reported), the replayed shares, the profile
    (``profiled``); first, with ``ptxas``, each key's ptxas and SASS
    report."""
    from ..ops.cuda.ilqr import kernel_env
    from .ab_ilqr_lanes import parent_libraries

    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    recorded = {case: VARIANT_CASES[case](device) for case in cases}
    keys = {case: call_key(calls[0]) for case, calls in recorded.items()}
    unique = list(dict.fromkeys(keys.values()))
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(max_workers=3) as pool:
        t0 = time.perf_counter()
        mine = pool.submit(build.build_variants, unique)
        other = pool.submit(parent_libraries, parent, unique) if parent else None
        prof = pool.submit(build.build_variants_with, unique, tmp, ("DMPC_ROLLOUT_PROFILE=1",), "profile") \
            if profiled else None
        mine.result()
        parents = other.result() if other else {}
        profiles = prof.result()[0] if prof else {}
        yield dict(build_seconds=time.perf_counter() - t0, keys=[key.name for key in unique])
        if ptxas:
            yield dict(ptxas_and_sass=ptxas_and_sass(unique, tmp))
        for case, calls in recorded.items():
            kinds = tuple(dict.fromkeys(_kind(k) for k, _, _ in calls))
            calls = [(k, a, {n: v for n, v in kw.items() if n != "use_cuda"}) for k, a, kw in calls]
            libs = {"policy": None}
            if keys[case] in parents:
                libs["parent"] = parents[keys[case]]
            refs = []
            ms, equal, scenarios, full_step, improved = time_calls(device, calls, libs, rounds, loops, lanes, kinds,
                                                                    refs)
            share = {v: e / scenarios for v, e in equal.items()}
            dyn = calls[0][2].get("dyn")
            env = None if dyn is None else kernel_env(dyn)
            T, B = calls[0][1][5].shape[:2]
            pick = rol.rollout_lanes(B, env, sm_count, T)
            rec = dict(case=case, key=keys[case].name, T=T, B=B, calls=len(calls), dispatched=list(kinds),
                       sm_count=sm_count, pick=pick, full_step_share=full_step / scenarios,
                       improved_share=improved / scenarios, bit_equal_share=share, ms=ms,
                       pick_ms={name: {k: ms[f"{k}/{name}/{pick}"] for k in kinds} for name in libs},
                       replay=replay_shares(refs, pick, env is None or env.cheap_step))
            if "parent" in libs:
                rec["pick_over_parent"] = {k: ms[f"{k}/policy/{pick}"] / ms[f"{k}/parent/{pick}"] for k in kinds}
            if keys[case] in profiles:
                rec["profile"] = profile_calls(device, profiles[keys[case]], calls, lanes)
            del calls, refs
            recorded[case] = None
            torch.cuda.empty_cache()
            if min(held_shares(share).values()) < 1.0:
                raise AssertionError(f"rollout variants A/B: a lane count is not bit for bit one lane: {rec}")
            yield rec


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", type=int, nargs="+", default=[128, 4096, 16384, 65536])
    parser.add_argument("--nn-batches", type=int, nargs="+", default=[1024, 65536])
    parser.add_argument("--other", nargs="*", default=["DMPC_ROLLOUT_FLIP_PASSES=1"],
                        help="defines of a second build to run beside the kernels (none: no second build)")
    parser.add_argument("--parent", help="the root of another checkout whose kernels run beside")
    parser.add_argument("--variants", nargs="*", choices=list(VARIANT_CASES), default=None,
                        help="run the variants' cases instead (all of them without names)")
    parser.add_argument("--profile", action="store_true", help="with --variants: cycles by phase from a profile build")
    parser.add_argument("--ptxas", action="store_true", help="with --variants: each key's ptxas and SASS report")
    parser.add_argument("--rounds", type=int, default=3)
    opts = parser.parse_args()
    device = require_card()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    if opts.variants is not None:
        records = run_variants(device, opts.variants or list(VARIANT_CASES), opts.parent, opts.profile, opts.ptxas,
                               opts.rounds)
    else:
        records = run(device, shapes(opts.batches, opts.nn_batches), other=tuple(opts.other), parent=opts.parent)
    for rec in records:
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
