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

Run on a machine with a CUDA device:

    python -m diffmpc_tpu_torch.diagnostics.ab_rollout_lanes [--batches 128 4096] [--other DEFINE=VALUE ...]

It prints the card's name and power limit, then one JSON record per shape.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import glob
import io
import json
import os
import subprocess
import tempfile
import types

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


def build_other(tmp: str, defines) -> ctypes.CDLL:
    """The rollout kernels built from the sources with the preprocessor
    ``defines`` (``NAME=VALUE``; one nvcc per source, in parallel)."""
    names = ["rollout.cu", "rollout_stream.cu"] + [os.path.basename(p) for p in
                                                   glob.glob(os.path.join(build.CSRC, "rollout_nn_l*.cu"))]
    return build.build_with([os.path.join(build.CSRC, name) for name in names], tmp, defines, "rollout_other")


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


def config2_problem(T: int, B: int, device, seed: int):
    """tests/oracles.py's random LQR problem (PSD cost L L'/nm + 0.5 I) at
    config 2's widths, drawn on the card: C, c, F, f, x_init."""
    g = torch.Generator(device=device).manual_seed(seed)
    n, m = CONFIG2_N, CONFIG2_M
    nm = n + m
    L = torch.randn((T, B, nm, nm), generator=g, device=device)
    C = L @ L.transpose(-1, -2) / nm + 0.5 * torch.eye(nm, device=device)
    c = torch.randn((T, B, nm), generator=g, device=device)
    F = torch.randn((T, B, n, nm), generator=g, device=device) * 0.5
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


def time_calls(device, calls: list, libs: dict, rounds: int, loops: int, lanes) -> tuple:
    """Stage each call once; on its inputs launch every (kernel, build, L),
    check it against the resident kernel at L = 1 of the first build, and
    time it alone, interleaved. Returns ``(ms summed over the calls,
    scenarios bit-equal summed, the calls' scenarios, full-step and any-step
    improvement counts)``, the first two keyed ``kind/build/L``."""
    variants = [(kind, name, L) for name in libs for kind in KINDS for L in lanes]
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


def run(device, cases: list, other=(), rounds: int = 2, loops: int = 3,
        lanes=rol.ROLLOUT_LANES):
    """Yield one record per ``(case, T, B)`` of :func:`shapes`; raises
    where a kernel, build or L is not bit for bit the resident kernel at
    L = 1 on every scenario of every call."""
    from ..ops.cuda.ilqr import kernel_env

    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    libs = {"policy": build.load()}
    with tempfile.TemporaryDirectory() as tmp:
        if other:
            libs["other"] = build_other(tmp, other)
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
            )
            del calls
            torch.cuda.empty_cache()
            if min(share.values()) < 1.0:
                raise AssertionError(f"rollout lanes A/B: a variant is not bit for bit one lane: {record_}")
            yield record_


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", type=int, nargs="+", default=[128, 4096, 16384, 65536])
    parser.add_argument("--nn-batches", type=int, nargs="+", default=[1024, 65536])
    parser.add_argument("--other", nargs="*", default=["DMPC_ROLLOUT_FLIP_PASSES=1"],
                        help="defines of a second build to run beside the kernels (none: no second build)")
    opts = parser.parse_args()
    device = require_card()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    for rec in run(device, shapes(opts.batches, opts.nn_batches), other=tuple(opts.other)):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
