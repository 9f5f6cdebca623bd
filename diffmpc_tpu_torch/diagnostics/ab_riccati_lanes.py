"""A/B on the card: the Riccati sweep kernels at each lane count.

The resident Riccati kernel (``csrc/riccati.cu``) and its streaming twin
(``csrc/riccati_stream.cu``), one kernel, run each scenario with a group of
L threads (``csrc/riccati.cuh``: each step's entries of Q and q, the m = 2
box QP's candidates, the gains' columns and the updated value's entries
shared out over the lanes), L in
:data:`~diffmpc_tpu_torch.ops.cuda.riccati.RICCATI_LANES`, each step's slice
staged for the group through shared memory (at one lane staged or read from
device memory); the wrapper's rule
(:func:`~diffmpc_tpu_torch.ops.cuda.riccati.riccati_lanes`) and, at one
lane, the launcher's staging choice (``csrc/riccati_launch.cuh``) pick per
batch.

The inputs are the ones ``mpc_solve`` gives the sweep: every call of a
solve, recorded (the kernel the dispatch took answers it meanwhile). For
each shape this stages each recorded call once and runs, on the same staged
inputs, both kernels at every built L (one lane staged and not), and
with ``parent`` the Riccati kernels of another checkout of the repository
(its own build) on the same staged inputs. It reports:

- per kernel, build and L, the share of scenarios whose ``K``, ``k``,
  ``free`` and ``n_qp`` equal the resident kernel's at L = 1 bit for bit
  over every call (the design gives 100%; it raises below that; the other
  checkout's share is reported, not held);
- per kernel, build and L, the time alone summed over the calls (CUDA
  events around launches on the staged inputs, the variants interleaved in
  each round, each one's minimum kept), the rule's pick and its time over
  L = 1's;
- the simplified value update (``value_update_exact_reg`` at the sweep's
  ``reg``) at L = 1 and at the rule's pick, on the same calls: its time and
  its own bit-equality across the two.
- each build's own one-lane staging choice for the shape's first call
  (``one_lane_staged``): every library keeps its own wave in its launch
  cache, so another checkout's build loaded beside picks by its own rule.

With ``profile`` it also builds the kernels with ``DMPC_RICCATI_PROFILE``
and reports, for config 2's calls at B=128 (T=20 and 128) at 16 lanes, the
cycles a step spends in each phase of ``riccati_lanes_step``, as the first
thread of block 0 counts them (``clock64``; the marks add their own few
cycles).

The shapes: BASELINE.json config 2 (``LinDx`` n=4, m=2, box +-0.6,
``lqr_iter`` 10 at T=20 and 20 at T=128) at the batches given; the
pendulum's step with ``FINITE_DIFF`` at T=20 (the resident kernel) and
T=256 (the twin), B=1024.

With ``--variants`` it runs instead the box QP's projected-Newton variants
(:data:`VARIANT_CASES`) on the sweeps their own solves record: a (6, 3)
``LinDx`` box-DDP at B=4096 (config 2's recipe at (6, 3)) under
``pnqp_enum`` "" (the loop) and "1" (the 27 candidates), and config 2 at
B=1000 under "0" (the loop at m = 2). Each record adds the mean of ``n_qp``
against ``pnqp_iter`` per call; ``--parent`` runs the other checkout's
builds of the same variants (its own ``csrc/build.py``) beside and reports
whether each call's ``K``, ``k``, ``free`` and ``n_qp`` equal this
checkout's bit for bit; ``--profile`` counts the 16-lane step's phases from
the variants built with ``DMPC_RICCATI_PROFILE``; ``--ptxas`` gives each
key's ptxas report and the local loads and stores of its kernels' SASS.

Run on a machine with a CUDA device:

    python -m diffmpc_tpu_torch.diagnostics.ab_riccati_lanes [--batches 128 4096] [--parent DIR] [--profile]
    python -m diffmpc_tpu_torch.diagnostics.ab_riccati_lanes --variants [CASE ...] [--parent DIR] [--profile]
        [--ptxas]

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
import time
import types
from concurrent.futures import ThreadPoolExecutor

import torch

from ..csrc import build
from ..models import PendulumDx
from ..ops.cuda import riccati as ric
from .ab_ilqr_lanes import problem
from .ab_rollout_lanes import config2_problem
from .card import require_card

KINDS = ("riccati", "riccati_stream")
CONFIG2_N, CONFIG2_M, CONFIG2_BOX = 4, 2, 0.6
CONFIG2_ITERS = {20: 10, 128: 20}
PEND_B, PEND_ITER = 1024, 10


def build_riccati(tmp: str, csrc: str, defines, label: str) -> ctypes.CDLL:
    """The Riccati sweep's sources of the ``csrc`` directory (this
    checkout's or another's) built with the preprocessor ``defines``."""
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(csrc, "riccati*.cu"))
                   if "blocked" not in p and "pieces" not in p)
    return build.build_with([os.path.join(csrc, name) for name in names], tmp, defines, f"riccati_{label}")


@contextlib.contextmanager
def recorded_calls(calls: list):
    """Record every Riccati sweep ``mpc_solve`` runs (both kernels' entry
    points as the dispatch in ``ops/lqr.py`` calls them): the inputs cloned."""
    from ..ops import lqr

    saved = {name: getattr(lqr, name) for name in ("riccati_backward_cuda", "riccati_backward_stream_cuda")}

    def recorder(name):
        def call(*args, **kw):
            calls.append((name, [a.clone() if torch.is_tensor(a) else a for a in args],
                          {k: v.clone() if torch.is_tensor(v) else v for k, v in kw.items()}))
            return saved[name](*args, **kw)

        return call

    for name in saved:
        setattr(lqr, name, recorder(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(lqr, name, fn)


def record(case: str, T: int, B: int, device) -> list:
    """The Riccati sweeps of one ``mpc_solve`` of ``case`` at ``(T, B)``:
    ``[(kind the dispatch took, args, kwargs), ...]``."""
    from .. import GradMethods, LinDx, MPCConfig, QuadCost, mpc_solve

    calls = []
    with torch.no_grad(), recorded_calls(calls), contextlib.redirect_stdout(io.StringIO()):
        if case == "config2":
            C, c, F, f, x0 = config2_problem(T, B, device, seed=T + B)
            cfg = MPCConfig(n_state=CONFIG2_N, n_ctrl=CONFIG2_M, T=T, lqr_iter=CONFIG2_ITERS[T],
                            exit_unconverged=False, detach_unconverged=False)
            mpc_solve(cfg, x0, QuadCost(C, c), LinDx(F, f), u_lower=-CONFIG2_BOX, u_upper=CONFIG2_BOX)
        else:
            x0, C, c, dyn, _, _ = problem(PendulumDx.default(device=device), B, T, device)
            cfg = MPCConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=PEND_ITER, eps=1e-5, exit_unconverged=False,
                            detach_unconverged=False, grad_method=GradMethods.FINITE_DIFF)
            mpc_solve(cfg, x0, QuadCost(C[0, 0], c[0, 0]), dyn, u_lower=-2.0, u_upper=2.0)
    return calls


PROFILE_PHASES = ("Q entries", "Q exchange", "QP: candidates and Newton point, or the loop", "QP exchange",
                  "fold and frozen mask",
                  "factor", "columns and stores", "K exchange", "value entries", "value exchange",
                  "staging wait", "staging copies")


def profile(device, tmp: str) -> list:
    """Cycles a step of each phase of the 16-lane step (config 2, B=128,
    T=20 and 128), from a build with ``DMPC_RICCATI_PROFILE``."""
    lib = build_riccati(tmp, build.CSRC, ("DMPC_RICCATI_PROFILE=1",), "profile")
    read = lib.diffmpc_riccati_profile
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    cycles = (ctypes.c_ulonglong * len(PROFILE_PHASES))()
    out = []
    for T in (20, 128):
        calls = record("config2", T, 128, device)
        read(cycles)  # cleared
        steps = 0
        for _, args, kw in calls:
            n, m = args[4], args[0].shape[-1] - args[4]
            staged = ric.stage_riccati(*args, lanes=16, **kw)
            ric._cuda_launcher(device, n, m, "riccati", types.SimpleNamespace(launches=0), lib)(
                ctypes.byref(staged.args), n, m, staged.mode)
            steps += args[0].shape[0]
        torch.cuda.synchronize()
        if read(cycles) != 0:
            raise RuntimeError("reading the profile build's cycles failed")
        out.append(dict(case="config2", T=T, B=128, lanes=16, calls=len(calls),
                        cycles_per_step={p: cycles[i] / steps for i, p in enumerate(PROFILE_PHASES)}))
    return out


def shapes(batches=(128, 4096, 65536)) -> list:
    """``(case, T, B)``: config 2 at T=20 and T=128 at ``batches``, the
    pendulum at T=20 and T=256 at B=1024."""
    return [("config2", T, B) for T in (20, 128) for B in batches] + [("pendulum", T, PEND_B) for T in (20, 256)]


def same_scenarios(got: ric.RiccatiResult, ref: ric.RiccatiResult) -> torch.Tensor:
    """Per scenario: K, k, free and n_qp equal ``ref``'s bit for bit (NaN
    where ``ref`` has NaN)."""
    same = torch.ones(ref.k.shape[1], dtype=torch.bool, device=ref.k.device)
    for f in ("K", "k", "free_mask", "n_qp_iter"):
        a, b = getattr(got, f), getattr(ref, f)
        eq = (a == b) | (torch.isnan(a) & torch.isnan(b)) if a.is_floating_point() else a == b
        same &= eq.reshape(eq.shape[0], eq.shape[1], -1).all(-1).all(0)
    return same


def _key(kind: str, name: str, L) -> str:
    return f"exact/{L}" if kind == "exact" else f"{kind}/{name}/{L}"


def time_calls(device, calls: list, libs: dict, rounds: int, loops: int, lanes, pick=None, enum: str = "",
               parent_counts=("1",), refs=None) -> tuple:
    """Stage each call once; on its inputs launch every (kernel, build, L:
    ``1`` one lane reading device memory, ``1s`` one lane staged; a build's
    library None: the one the wrapper loads), with the box QP of ``enum``,
    and with ``pick`` the simplified update at L = 1 and ``pick``; check each
    against the resident kernel at ``1`` of the first build (the simplified
    update against itself at ``1``), and time it alone, interleaved. Returns
    ``(ms summed over the calls, scenarios bit-equal summed, the calls'
    scenarios)``, keyed ``kind/build/L`` (``exact/L`` for the simplified
    update; the other checkout, ``parent``, at ``parent_counts``); appends
    each call's reference result to ``refs`` where given."""
    counts = ["1", "1s"] + [str(L) for L in lanes if L > 1]
    variants = [(kind, name, L) for name in libs if name != "parent" for kind in KINDS for L in counts]
    variants += [(kind, "parent", L) for kind in KINDS for L in parent_counts if "parent" in libs]
    if pick is not None:
        variants += [("exact", "policy", L) for L in dict.fromkeys(["1", pick])]
    ms = {v: 0.0 for v in variants}
    equal = {v: 0 for v in variants}
    scenarios = 0
    counted = types.SimpleNamespace(launches=0, last_lanes=None)
    for _, args, kw in calls:
        C, n = args[0], args[4]
        B, m = C.shape[1], C.shape[-1] - n
        staged = ric.stage_riccati(*args, **kw)
        launches = {}
        for kind, name, L in variants:
            a = ric._RiccatiArgs.from_buffer_copy(staged.args)
            a.lanes, a.staged = int(L.rstrip("s")), int(L.endswith("s"))
            if kind == "exact":
                a.exact_update = 1
            launch = ric._cuda_launcher(device, n, m, "riccati" if kind == "exact" else kind, counted, libs[name],
                                        pnqp_enum=enum)
            launches[(kind, name, L)] = (launch, a)
        first = {}
        for v, (launch, a) in launches.items():
            launch(ctypes.byref(a), n, m, staged.mode)
            got = staged.result()
            key = "exact" if v[0] == "exact" else "full"
            if key not in first:
                first[key] = ric.RiccatiResult(*(t.clone() for t in got))
            equal[v] += int(same_scenarios(got, first[key]).sum())
        if refs is not None:
            refs.append(first["full"])
        scenarios += B
        torch.cuda.synchronize()
        best = {}
        for _ in range(rounds):
            for v, (launch, a) in launches.items():
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(loops):
                    launch(ctypes.byref(a), n, m, staged.mode)
                end.record()
                end.synchronize()
                best[v] = min(best.get(v, float("inf")), start.elapsed_time(end) / loops)
        for v in variants:
            ms[v] += best[v]
        del staged, launches, first
    return {_key(*v): t for v, t in ms.items()}, {_key(*v): e for v, e in equal.items()}, scenarios


def one_lane_picks(device, call, libs: dict) -> dict:
    """Each build's own one-lane choice for the recorded ``call``: whether
    its launcher stages the slices (``one_lane_staged``, asked for by
    ``staged = -1`` and written back), keyed by build."""
    _, args, kw = call
    n = args[4]
    m = args[0].shape[-1] - n
    staged = ric.stage_riccati(*args, **kw)
    picks = {}
    for name, lib in libs.items():
        a = ric._RiccatiArgs.from_buffer_copy(staged.args)
        a.lanes, a.staged = 1, -1
        ric._cuda_launcher(device, n, m, "riccati", types.SimpleNamespace(launches=0), lib)(
            ctypes.byref(a), n, m, staged.mode)
        picks[name] = bool(a.staged)
    torch.cuda.synchronize()
    return picks


def run(device, cases: list, parent=None, rounds: int = 2, loops: int = 3, lanes=ric.RICCATI_LANES,
        profiled: bool = False):
    """Yield one record per ``(case, T, B)`` of :func:`shapes`; raises
    where a kernel, build or L of this checkout is not bit for bit the
    resident kernel at one lane on every scenario of every call (the
    simplified update: itself at one lane). ``parent``: the root of another
    checkout whose Riccati kernels run beside; ``profiled``: first the
    records of :func:`profile`."""
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    libs = {"policy": build.load()}
    with tempfile.TemporaryDirectory() as tmp:
        if parent:
            libs["parent"] = build_riccati(tmp, os.path.join(parent, "diffmpc_tpu_torch", "csrc"), (), "parent")
        if profiled:
            yield from profile(device, tmp)
        for case, T, B in cases:
            calls = record(case, T, B, device)
            C, n = calls[0][1][0], calls[0][1][4]
            m = C.shape[-1] - n
            ric.riccati_backward_cuda(*calls[0][1], **calls[0][2])  # the wrapper's pick
            L = ric.riccati_backward_cuda.last_lanes
            pick = "1s" if L == 1 and ric.riccati_backward_cuda.last_staged else str(L)
            ms, equal, scenarios = time_calls(device, calls, libs, rounds, loops if B <= 16384 else max(1, loops // 2),
                                              lanes, pick)
            share = {v: e / scenarios for v, e in equal.items()}
            held = {v: sh for v, sh in share.items() if "/parent/" not in v}
            record_ = dict(
                case=case, T=T, B=B, n=n, m=m, calls=len(calls), dispatched=sorted({k for k, _, _ in calls}),
                sm_count=sm_count, pick=pick, bit_equal_share=share, ms=ms,
                pick_over_one={k: ms[f"{k}/policy/{pick}"] / ms[f"{k}/policy/1"] for k in KINDS},
                pick_over_parent={k: ms[f"{k}/policy/{pick}"] / ms[f"{k}/parent/1"] for k in KINDS} if parent else None,
                one_lane_staged=one_lane_picks(device, calls[0], libs),
                exact_over_full_at_pick=ms[f"exact/{pick}"] / ms[f"riccati/policy/{pick}"],
            )
            del calls
            torch.cuda.empty_cache()
            if min(held.values()) < 1.0:
                raise AssertionError(f"Riccati lanes A/B: a variant is not bit for bit one lane: {record_}")
            yield record_


# ---------------------------------------------------------------------------
# The box QP's projected-Newton variants, on the sweeps their solves record.
# ---------------------------------------------------------------------------

LINDX63_B, LOOP42_B = 4096, 1000


def _variant_calls(n: int, m: int, B: int, enum: str, device) -> list:
    """The Riccati sweeps of one box-DDP solve at ``(n, m)``: config 2's
    recipe (F scaled to its open-loop growth), box +-0.6, T=20, ten
    iterations, ``pnqp_enum`` ``enum``, B scenarios."""
    from .. import LinDx, MPCConfig, QuadCost, mpc_solve

    C, c, F, f, x0 = config2_problem(20, B, device, seed=33 if n == 6 else 20 + B, n=n, m=m)
    cfg = MPCConfig(n_state=n, n_ctrl=m, T=20, lqr_iter=10, exit_unconverged=False, detach_unconverged=False,
                    pnqp_enum=enum)
    calls = []
    with torch.no_grad(), recorded_calls(calls), contextlib.redirect_stdout(io.StringIO()):
        mpc_solve(cfg, x0, QuadCost(C, c), LinDx(F, f), u_lower=-CONFIG2_BOX, u_upper=CONFIG2_BOX)
    return calls


# case -> (n, m, B, pnqp_enum)
VARIANT_CASES = {"lindx63": (6, 3, LINDX63_B, ""), "lindx63_enum1": (6, 3, LINDX63_B, "1"),
                 "config2_enum0": (CONFIG2_N, CONFIG2_M, LOOP42_B, "0")}


def variant_key(n: int, m: int, enum: str):
    from ..ops.cuda.ilqr import kernel_variant_key
    from ..ops.cuda.riccati_entries import pnqp_enum_flag

    return kernel_variant_key("riccati", n, m, enum=pnqp_enum_flag(m, enum))


def variant_profile(device, lib, calls: list, n: int, m: int, enum: str) -> dict:
    """Cycles a step of each phase of the 16-lane step over the calls, from
    the variant's profile build ``lib`` (the first thread of block 0)."""
    read = lib.diffmpc_riccati_profile
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    cycles = (ctypes.c_ulonglong * len(PROFILE_PHASES))()
    read(cycles)  # cleared
    steps = 0
    for kind, args, kw in calls:
        staged = ric.stage_riccati(*args, lanes=16, **kw)
        ric._cuda_launcher(device, n, m, "riccati", types.SimpleNamespace(launches=0), lib, pnqp_enum=enum)(
            ctypes.byref(staged.args), n, m, staged.mode)
        steps += args[0].shape[0]
    torch.cuda.synchronize()
    if read(cycles) != 0:
        raise RuntimeError("reading the profile build's cycles failed")
    return dict(lanes=16, calls=len(calls), cycles_per_step={p: cycles[i] / steps for i, p in enumerate(PROFILE_PHASES)})


def run_variants(device, cases, parent=None, profiled: bool = False, ptxas: bool = False, rounds: int = 3,
                 loops: int = 3, lanes=ric.RICCATI_LANES):
    """Yield a record of each variant case: every Riccati call of its solve
    through both kernels at every L (one lane staged and not), held bit-equal
    to one lane, ``parent``'s builds beside (their bits against this
    checkout's reported), mean ``n_qp``, and with ``profiled`` the 16-lane
    step's phases; first, with ``ptxas``, each key's ptxas and SASS
    report."""
    from .ab_ilqr_lanes import parent_libraries
    from .ab_rollout_lanes import sass_local_accesses
    from .card import ptxas_report

    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    keys = {case: variant_key(*VARIANT_CASES[case][:2], VARIANT_CASES[case][3]) for case in cases}
    unique = list(dict.fromkeys(keys.values()))
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(max_workers=3) as pool:
        t0 = time.perf_counter()
        mine = pool.submit(build.build_variants, unique)
        other = pool.submit(parent_libraries, parent, unique) if parent else None
        prof = pool.submit(build.build_variants_with, unique, tmp, ("DMPC_RICCATI_PROFILE=1",), "profile") \
            if profiled else None
        built = mine.result()
        parents = other.result() if other else {}
        profiles = prof.result()[0] if prof else {}
        yield dict(build_seconds=time.perf_counter() - t0, keys=[key.name for key in unique])
        if ptxas:
            logs = {key: log for key, (_, log) in built.items()}
            stale = [key for key, log in logs.items() if not log]
            if stale:  # built before this process: build again for the log
                logs.update(build.build_variants_with(stale, tmp, (), "ptxas")[1])
            yield dict(ptxas_and_sass={key.name: dict(ptxas=ptxas_report(logs[key], "riccati_kernel"),
                                                      sass=sass_local_accesses(built[key][0])) for key in unique})
        for case in cases:
            n, m, B, enum = VARIANT_CASES[case]
            calls = _variant_calls(n, m, B, enum, device)
            libs = {"policy": None}
            if keys[case] in parents:
                libs["parent"] = parents[keys[case]]
            counts = ["1", "1s"] + [str(L) for L in lanes if L > 1]
            refs = []
            ms, equal, scenarios = time_calls(device, calls, libs, rounds, loops, lanes, enum=enum,
                                              parent_counts=counts, refs=refs)
            pnqp_iter = calls[0][2].get("pnqp_iter", 8)
            mean_n_qp = [float(r.n_qp_iter.float().mean()) for r in refs]
            rec = dict(case=case, key=keys[case].name, n=n, m=m, B=B, pnqp_enum=enum, calls=len(calls),
                       sm_count=sm_count, ms=ms, bit_equal_share={v: e / scenarios for v, e in equal.items()},
                       pnqp_iter=pnqp_iter, mean_n_qp=mean_n_qp,
                       mean_n_qp_over_pnqp_iter=[q / pnqp_iter for q in mean_n_qp])
            if "parent" in libs:
                rec["change_over_parent"] = {f"{k}/{L}": ms[f"{k}/policy/{L}"] / ms[f"{k}/parent/{L}"]
                                             for k in KINDS for L in counts}
            if keys[case] in profiles:
                rec["profile"] = variant_profile(device, profiles[keys[case]], calls, n, m, enum)
            del calls
            torch.cuda.empty_cache()
            held = {v: sh for v, sh in rec["bit_equal_share"].items() if "/parent/" not in v}
            if min(held.values()) < 1.0:
                raise AssertionError(f"Riccati variants A/B: a lane count is not bit for bit one lane: {rec}")
            yield rec


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", type=int, nargs="+", default=[128, 4096, 65536])
    parser.add_argument("--parent", help="the root of another checkout whose Riccati kernels run beside")
    parser.add_argument("--profile", action="store_true", help="first count each phase's cycles of the 16-lane step")
    parser.add_argument("--variants", nargs="*", choices=list(VARIANT_CASES), default=None,
                        help="run the projected-Newton variants' cases instead (all of them without names)")
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
        records = run(device, shapes(opts.batches), parent=opts.parent, profiled=opts.profile)
    for rec in records:
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
