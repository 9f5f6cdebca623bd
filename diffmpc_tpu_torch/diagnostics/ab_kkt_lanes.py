"""A/B on the card: the KKT backward kernels at each lane count.

The resident KKT kernel (``csrc/kkt.cu``) and its streaming twin
(``csrc/kkt_stream.cu``), one kernel, run each scenario with a group of L
threads (``csrc/kkt.cuh``: the auxiliary sweep's entries shared out over
the lanes, the other two sweeps whole in every lane, the gradients' stores
shared out), L in :data:`~diffmpc_tpu_torch.ops.cuda.kkt.KKT_LANES`, with K, k and
p kept in the group's shared memory (``on_chip``) or in device memory, and
(one lane) each step's slice loaded while the step before computes
(``prefetch``) or at its step; the wrapper's rule
(:func:`~diffmpc_tpu_torch.ops.cuda.kkt.kkt_lanes`) picks L per batch, the
launcher (``lanes_launch`` in ``csrc/kkt_launch.cuh``) the other two (the
twin keeps K, k, p in device memory).

The inputs are the ones a gradient through ``mpc_solve`` gives the
backward: every KKT call of a solve + gradient, recorded (the kernel the
dispatch took answers it meanwhile). For each case this stages each call
once (a C or F shared by every scenario read in place, as the wrapper does)
and runs on the same staged inputs the kernel the dispatch takes at every
built L with the launcher's choices, one lane with and without the
prefetch, and the resident kernel above one lane with K, k and p on chip
and in device memory. With ``--parent DIR``, the checkout at ``DIR``
(another commit of this repository, unpacked by ``git archive``) is
imported beside this one under a name of its own: its KKT kernel, built by
its own build at first use and called through its own ``KktArgs`` on a
staged copy of the same inputs (C and F copied batch-minor), and its
wrapper on the call's inputs, each timed in the same rounds as this
checkout's. Every launch that fails raises. It reports:

- per call, whether every variant's outputs equal the dispatched kernel's at
  L = 1 bit for bit (the design gives it; it raises otherwise), and that
  kernel's largest distance from the plain version, held to
  ``1e-4 * max(1, max|plain|)`` (raises beyond);
- per variant the time alone (CUDA events around launches on the staged
  inputs, the variants interleaved in each round): each round's time
  (``ms_rounds``) and the minimum (``ms``), the rule's pick and its time
  over L = 1's and over the parent's;
- the wrapper's call, its staging alone in place and with C and F copied,
  and the parent's wrapper, interleaved the same way (``*_ms``,
  ``call_rounds``); the plain version's time.
- each build's own one-lane choice (``one_lane_prefetch``: this
  checkout's and, with ``--parent``, the parent's launcher asked with
  ``prefetch = -1``): every library keeps its own wave in its launch cache,
  so the parent's build picks by its own rule.

The cases: the headline's gradient (pendulum, goal cost, box +-2, T=20,
``lqr_iter`` 10, the gradient of mean(us**2) with respect to the env's
params) at B=1024 and 65,536, and at T=512 (B=1024, the twin); the (6, 3)
MLP's imitation gradient (6-16-16-6, residual, tanh, seed 0, the cost and
box of ``scripts/ab_pnqp_enum3.py``, B=1024, with respect to every weight
and bias); a (6, 3) ``LinDx`` box-DDP (config 2's recipe, its F scaled by
sqrt(4 / 6)) at B=4096; BASELINE.json config 2 at T=20 and T=128 (the twin),
B=128, 4096 and 65,536, with respect to c.

Run on a machine with a CUDA device:

    python -m diffmpc_tpu_torch.diagnostics.ab_kkt_lanes [--cases ...] [--parent DIR] [--rounds N]

It prints the card's name and power limit, then one JSON record per case.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import types

import numpy as np
import torch

from ..models import NNDynamics, PendulumDx
from ..ops.cuda import kkt
from ..ops.cuda.horizon import streams_kkt
from .ab_ilqr_lanes import swing_up_starts
from .ab_rollout_lanes import config2_problem
from .card import cuda_ms, require_card

CASES = ("pendulum_T20_B1024", "pendulum_T20_B65536", "mlp63_T20_B1024", "lin63_T20_B4096",
         "config2_T20_B128", "config2_T20_B4096", "config2_T20_B65536", "config2_T128_B128",
         "config2_T128_B4096", "config2_T128_B65536", "pendulum_T512_B1024")
ITERS = {20: 10, 128: 20, 512: 10}
SL_HIDDEN, SL_BOX, BOX = (16, 16), 0.5, 0.6


def parse(case: str) -> tuple:
    """``(kind, T, B)`` of a case name ``<kind>_T<T>_B<B>``."""
    kind, t, b = case.split("_")
    return kind, int(t[1:]), int(b[1:])


@contextlib.contextmanager
def recorded_calls(calls: list):
    """Record every KKT backward that a gradient through ``mpc_solve`` runs
    (the ``kkt_backward`` op of ``ops/library.py`` calls
    ``kkt_backward_fused``): the inputs cloned."""
    from ..ops import library

    saved = library.kkt_backward_fused

    def call(*args, **kw):  # a C or F read in place stays as it is: a clone would copy it
        calls.append(([a if kkt.reads_in_place(a) else a.clone() for a in args], dict(kw)))
        return saved(*args, **kw)

    library.kkt_backward_fused = call
    try:
        yield calls
    finally:
        library.kkt_backward_fused = saved


def lin_problem(T: int, B: int, n: int, m: int, device, seed: int) -> tuple:
    """Config 2's random LQR recipe (``ab_rollout_lanes.config2_problem``)
    at ``(n, m)``, its F scaled by sqrt(4 / n) to config 2's open-loop
    growth: C, c, F, f, x_init."""
    if (n, m) == (4, 2):
        return config2_problem(T, B, device, seed)
    g = torch.Generator(device=device).manual_seed(seed)
    nm = n + m
    L = torch.randn((T, B, nm, nm), generator=g, device=device)
    C = L @ L.transpose(-1, -2) / nm + 0.5 * torch.eye(nm, device=device)
    c = torch.randn((T, B, nm), generator=g, device=device)
    F = torch.randn((T, B, n, nm), generator=g, device=device) * 0.5 * (4 / n) ** 0.5
    f = torch.randn((T, B, n), generator=g, device=device) * 0.5
    return C, c, F, f, torch.randn((B, n), generator=g, device=device)


def record(case: str, device) -> list:
    """The KKT calls of one solve + gradient of ``case``: ``[(args, kw)]``."""
    from .. import LinDx, MPCConfig, QuadCost, mpc_solve

    kind, T, B = parse(case)
    calls = []
    with recorded_calls(calls), contextlib.redirect_stdout(io.StringIO()):
        if kind == "pendulum":
            dx = PendulumDx.default(device=device)
            q, p = dx.get_true_obj()
            prm = dx.params.clone().requires_grad_(True)
            x0 = torch.tensor(swing_up_starts(B), device=device)
            cfg = MPCConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=ITERS[T], eps=1e-5, exit_unconverged=False,
                            detach_unconverged=False)
            sol = mpc_solve(cfg, x0, QuadCost(torch.diag(q), p), dx.replace(params=prm), u_lower=-2.0, u_upper=2.0)
            torch.autograd.grad((sol.us ** 2).mean(), prm)
        elif kind == "mlp63":
            n, m = 6, 3
            mlp = NNDynamics.init(n, m, hidden=SL_HIDDEN, residual=True, device=device,
                                  generator=torch.Generator(device=device).manual_seed(0))
            x0 = torch.tensor(np.random.default_rng(1).uniform(-0.8, 0.8, (B, n)), dtype=torch.float32,
                              device=device)
            cost = QuadCost(torch.diag(torch.tensor([1.0] * n + [0.02] * m, device=device)),
                            torch.tensor([0.0] * n + [0.08] * m, device=device))
            leaves = [a.clone().requires_grad_(True) for a in mlp.weights + mlp.biases]
            k = len(mlp.weights)
            cfg = MPCConfig(n_state=n, n_ctrl=m, T=T, lqr_iter=10, pnqp_iter=8, pnqp_enum="1",
                            exit_unconverged=False, detach_unconverged=False)
            sol = mpc_solve(cfg, x0, cost, mlp.replace(weights=tuple(leaves[:k]), biases=tuple(leaves[k:])),
                            u_lower=-SL_BOX, u_upper=SL_BOX)
            torch.autograd.grad((sol.us ** 2).mean(), leaves)
        else:
            n, m = (4, 2) if kind == "config2" else (6, 3)
            C, c, F, f, x0 = lin_problem(T, B, n, m, device, seed=T + B)
            c = c.requires_grad_(True)
            cfg = MPCConfig(n_state=n, n_ctrl=m, T=T, lqr_iter=ITERS[T], exit_unconverged=False,
                            detach_unconverged=False)
            sol = mpc_solve(cfg, x0, QuadCost(C, c), LinDx(F, f), u_lower=-BOX, u_upper=BOX)
            torch.autograd.grad((sol.us ** 2).mean() + (sol.xs ** 2).mean(), c)
    torch.cuda.synchronize()
    return calls


def load_tree(root: str, module: str = "ops.cuda.kkt"):
    """Another checkout's port, imported beside this one under a name of its
    own: its ``module`` (by default ``ops.cuda.kkt``, with its own wrapper,
    ``_KktArgs`` and build, which compiles its kernels at first use into that
    checkout's ``_build``). The package and its ``ops`` and ``ops.cuda`` are entered
    without their ``__init__``, so that nothing of the solve path is
    imported there: the operators of ``ops/library.py`` are global to the
    process and registered once, by this checkout."""
    pkg_dir = os.path.join(os.path.abspath(root), "diffmpc_tpu_torch")
    name = "_tree_" + hashlib.sha256(pkg_dir.encode()).hexdigest()[:12] + "_diffmpc_tpu_torch"
    for sub in ("", ".ops", ".ops.cuda"):
        if name + sub not in sys.modules:
            package = types.ModuleType(name + sub)
            package.__path__ = [os.path.join(pkg_dir, *sub.split(".")[1:])]
            sys.modules[name + sub] = package
    return importlib.import_module(f"{name}.{module}")


def tree_args(tree_kkt, staged: kkt.StagedKkt):
    """The other checkout's own ``KktArgs`` for ``staged`` (C and F copied
    batch-minor), field by field; raises where that struct has a field this
    one lacks."""
    ours = {name for name, _ in kkt._KktArgs._fields_}
    theirs = [name for name, _ in tree_kkt._KktArgs._fields_]
    if missing := [name for name in theirs if name not in ours]:
        raise RuntimeError(f"the other checkout's KktArgs has fields this one has not: {missing}")
    return tree_kkt._KktArgs(*(getattr(staged.args, name) for name in theirs))


def same_bits(got, ref) -> bool:
    return all(torch.equal(g, r) for g, r in zip(got, ref))


def time_variants(launches: dict, rounds: int, loops: int) -> dict:
    """Each launch alone, interleaved, after one call each to warm up:
    ``{name: [ms of each round]}``; a round runs the variants in order and
    then in reverse."""
    names, out = list(launches), {name: [] for name in launches}
    for fn in launches.values():
        fn()
    torch.cuda.synchronize()
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            fn = launches[name]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(loops):
                fn()
            end.record()
            end.synchronize()
            out[name].append(start.elapsed_time(end) / loops)
    return out


def run_call(device, args, kw, tree_kkt, rounds: int, loops: int) -> dict:
    """One recorded call through every variant (the module's docstring);
    ``tree_kkt``: another checkout's ``ops.cuda.kkt`` (:func:`load_tree`) or
    None."""
    C, c, F, r, tau, tight = args
    T, B, n, m = kkt._check_shapes(C, c, F, r, tau, tight)
    exact = kkt.kkt_exact_update(kw["reg"], kw["value_update_exact_reg"])
    twin = streams_kkt(T, n, m)
    f32 = [a.to(torch.float32) for a in (C, c, F, r, tau)] + [tight]
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    pick_lanes = kkt.kkt_lanes(B, n, m, sm_count, T)
    counted = types.SimpleNamespace(launches=0, last_lanes=None, last_on_chip=None)
    staged = kkt.stage_kkt(*f32, reg=kw["reg"])
    kinds = {"twin": "kkt_backward_stream", "resident": "kkt_backward"}
    fns = {k: kkt._cuda_launcher(device, n, m, kind, counted, exact=exact) for k, kind in kinds.items()}
    dispatched = "twin" if twin else "resident"
    variants = {}  # name -> (launcher, lanes, on_chip, prefetch)
    for L in kkt.KKT_LANES:
        variants[f"{dispatched}/L{L}/auto"] = (fns[dispatched], L, -1, -1)
        if L == 1:
            for pf in (0, 1):
                variants[f"{dispatched}/L1/{'prefetch' if pf else 'at_its_step'}"] = (fns[dispatched], 1, -1, pf)
        else:
            for on in (0, 1):
                variants[f"resident/L{L}/{'onchip' if on else 'device'}"] = (fns["resident"], L, on, -1)
    launches, refs, same, choices, parent_prefetch = {}, None, {}, {}, None
    for name, (fn, L, on, pf) in variants.items():
        a = kkt._KktArgs.from_buffer_copy(staged.args)
        a.lanes, a.on_chip, a.prefetch = L, on, pf
        fn(ctypes.byref(a), n, m)  # raises where the launch fails
        torch.cuda.synchronize()
        got = staged.result()
        if refs is None:
            refs = tuple(t.clone() for t in got)
        same[name] = same_bits(got, refs)
        choices[name] = dict(on_chip=bool(a.on_chip), prefetch=bool(a.prefetch))
        launches[name] = (lambda fn=fn, a=a: fn(ctypes.byref(a), n, m))
    plain = kkt.kkt_backward_plain(*args, reg=kw["reg"], value_update_exact_reg=kw["value_update_exact_reg"])
    err = max(float((g.to(p.dtype) - p).abs().max()) for g, p in zip(refs, plain))
    bound = max(1e-4 * max(1.0, float(p.abs().max())) for p in plain)
    plain_ms = cuda_ms(lambda: kkt.kkt_backward_plain(*args, reg=kw["reg"],
                                                     value_update_exact_reg=kw["value_update_exact_reg"]), 1, 1)
    del plain
    calls = {
        "wrapper": lambda: kkt.kkt_backward_fused(*args, **kw),
        "stage": lambda: kkt.stage_kkt(*f32, reg=kw["reg"]),
        "stage_copies": lambda: kkt.stage_kkt(*f32, reg=kw["reg"], in_place=False),
    }
    if tree_kkt is not None:
        # its kernel alone on a staged copy of the same inputs (C and F
        # copied batch-minor), through its own struct and launcher; its
        # wrapper on the call's own inputs
        copied = kkt.stage_kkt(*f32, reg=kw["reg"], lanes=pick_lanes, in_place=False)
        parent_args = tree_args(tree_kkt, copied)
        parent_fn = tree_kkt._cuda_launcher(device, n, m, kinds[dispatched], types.SimpleNamespace(launches=0),
                                            exact=exact)
        parent_fn(ctypes.byref(parent_args), n, m)
        torch.cuda.synchronize()
        same["parent"] = same_bits(copied.result(), refs)
        one = tree_args(tree_kkt, copied)
        one.lanes, one.on_chip, one.prefetch = 1, -1, -1
        parent_fn(ctypes.byref(one), n, m)
        parent_prefetch = bool(one.prefetch)
        launches = {"parent": lambda: parent_fn(ctypes.byref(parent_args), n, m), **launches}
        calls["parent_wrapper"] = lambda: tree_kkt.kkt_backward_fused(*args, **kw)
    ms_rounds = time_variants(launches, rounds, loops)
    call_rounds = time_variants(calls, rounds, loops)
    ms = {name: min(v) for name, v in ms_rounds.items()}
    pick = f"{dispatched}/L{pick_lanes}/auto"
    return dict(
        T=T, B=B, n=n, m=m, exact=exact, dispatched=dispatched, sm_count=sm_count,
        C_in_place=kkt.reads_in_place(f32[0]), F_in_place=kkt.reads_in_place(f32[2]),
        pick=dict(name=pick, lanes=pick_lanes, **choices[pick]), choices=choices,
        bit_equal={k: v for k, v in same.items() if k != "parent"}, parent_bit_equal=same.get("parent"),
        max_abs_err=err, err_bound=bound, ms=ms, ms_rounds=ms_rounds, plain_ms=plain_ms,
        pick_over_one=ms[pick] / ms[f"{dispatched}/L1/auto"],
        pick_over_parent=ms[pick] / ms["parent"] if "parent" in ms else None,
        one_lane_prefetch=dict(this=choices[f"{dispatched}/L1/auto"]["prefetch"], parent=parent_prefetch),
        **{f"{name}_ms": min(v) for name, v in call_rounds.items()}, call_rounds=call_rounds)


def run(device, cases, parent=None, rounds: int = 4, loops: int = 5):
    """Yield one record per case; raises where a variant is not bit for bit
    the dispatched kernel at one lane, where that kernel leaves
    ``1e-4 * max(1, max|plain|)`` of the plain version, or where a launch
    fails. ``parent``: the root of another checkout, whose KKT kernel and
    wrapper run beside (:func:`load_tree`)."""
    tree_kkt = load_tree(parent) if parent else None
    for case in cases:
        calls = record(case, device)
        _, T, B = parse(case)
        recs = [run_call(device, args, kw, tree_kkt, rounds, loops if B <= 16384 else 2) for args, kw in calls]
        del calls
        torch.cuda.empty_cache()
        out = dict(case=case, calls=len(recs), **(recs[0] if len(recs) == 1 else dict(records=recs)))
        for rec in recs:
            if not all(rec["bit_equal"].values()) or not rec["max_abs_err"] <= rec["err_bound"]:
                raise AssertionError(f"KKT lanes A/B: a variant is not bit for bit one lane, or one lane "
                                     f"leaves the plain version's bound: {out}")
        yield out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cases", nargs="+", default=list(CASES),
                        help="<kind>_T<T>_B<B>, kind one of pendulum, mlp63, lin63, config2")
    parser.add_argument("--parent", help="the root of another checkout whose KKT kernels run beside")
    parser.add_argument("--rounds", type=int, default=4, help="timing rounds, each variant's minimum kept")
    opts = parser.parse_args()
    device = require_card()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    for rec in run(device, opts.cases, parent=opts.parent, rounds=opts.rounds):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
