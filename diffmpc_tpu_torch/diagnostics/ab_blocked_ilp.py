"""A/B on the card: the depth-blocked Riccati sweep against the serial one.

Counterpart of the JAX package's ``scripts/ab_blocked_ilp.py``: the
unconstrained (free-mode) sweep, the regime where composing adjacent steps'
value maps is exact, timed as the resident serial kernel
(``csrc/riccati.cu``) against the depth-blocked kernel
(``csrc/riccati_blocked.cu``: one thread per (block, scenario)) at ``D = 2``
and ``4``, whose chain across blocks is ``T / D`` applies instead of ``T``
steps. Each shape's inputs come from :func:`make_problem`, the script's
recipe with numpy's generator, so both packages see the same numbers.

With ``--parent DIR``, the checkout at ``DIR`` (another commit of this
repository, unpacked by ``git archive``) is imported beside this one under a
name of its own (:func:`~.ab_kkt_lanes.load_tree`): its blocked kernel, built
by its own build at first use and staged by its own ``run_staged_blocked``
(with whatever scratch it allocates), timed in the same rounds
(``parent_D<D>``).

Timing: CUDA events around the kernels alone on staged inputs
(:func:`~diffmpc_tpu_torch.diagnostics.card.interleaved_ms`), the variants
interleaved in each of ``N_ROUNDS`` rounds, each variant's minimum kept.
Each record also gives every blocked output's distance from the serial
kernel's and from its plain version's, each variant's bounds (the bytes the function must
move, its operations, and its chain: the dependent operations of one
scenario counted from the source, at ``DEP_OP_CYCLES`` each at the card's
maximum clock) and, for the first shape, the plain version's time.

With ``--profile``, it first builds ``csrc/riccati_blocked.cu`` again with
``DMPC_BLOCKED_PROFILE`` (:func:`~diffmpc_tpu_torch.csrc.build.build_with`)
and prints, for each shape and D, the cycles of each phase of thread 0 of a
CTA (block 0 of its first scenario, the chain's last link: phases 1-2,
phase 3 with its wait for the chain, phase 4), averaged over the CTAs, and
phase 3's share of them: the blocked chain's share of the time.

Run on a machine with a CUDA device:

    python -m diffmpc_tpu_torch.diagnostics.ab_blocked_ilp [--parent DIR] [--profile]

It prints the card's name and power limit, then one JSON record per shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from ..csrc import build
from ..ops.cuda import riccati as ric
from ..ops.cuda import riccati_blocked as rb
from .card import bound, chain_ms, interleaved_ms, max_sm_clock_mhz, require_card

# (T, B, n, m, blocks): the script's three shapes (n = 3, m = 1), BASELINE.json
# config 1's unconstrained shape (T must divide by D: D = 2 only) and config
# 2's widths at T = 128, B = 128, where one scenario's chain is the time
SHAPES = (
    (20, 1024, 3, 1, (2, 4)),
    (20, 65536, 3, 1, (2, 4)),
    (128, 8192, 3, 1, (2, 4)),
    (10, 32, 3, 2, (2,)),
    (128, 128, 4, 2, (2, 4)),
)
N_ROUNDS = 6
# the JAX package's bound between the blocked and the serial sweep
# (tests/test_pallas_riccati.py), relative to max(1, max|serial|)
VS_SERIAL_TOL = 5e-4
# the kernel against its plain version, relative to max(1, max|plain|)
VS_PLAIN_TOL = 1e-4


def _gap(got, want) -> dict:
    """max|got - want| of K and k, each beside the scale max(1, max|want|)."""
    return {name: dict(max_abs=float((getattr(got, name) - getattr(want, name)).abs().max()),
                       scale=max(1.0, float(getattr(want, name).abs().max())))
            for name in ("K", "k")}


def _held(gaps: dict, tol: float) -> bool:
    return all(e["max_abs"] <= tol * e["scale"] for d in gaps.values() for e in d.values())


def make_problem(T: int, B: int, n: int, m: int, seed: int):
    """The script's random unconstrained problem (``ab_blocked_ilp.py:45-55``)
    as float32 numpy arrays ``C, c, F, f``: an SPD cost ``0.1 V V' + I``,
    random dynamics and offsets."""
    rng = np.random.default_rng(seed)
    nm = n + m
    V = rng.normal(size=(T, B, nm, nm)).astype(np.float32)
    C = np.einsum("tbij,tbkj->tbik", V, V) * 0.1 + np.eye(nm, dtype=np.float32)
    c = (rng.normal(size=(T, B, nm)) * 0.5).astype(np.float32)
    F = (rng.normal(size=(T, B, n, nm)) * 0.4).astype(np.float32)
    f = (rng.normal(size=(T, B, n)) * 0.2).astype(np.float32)
    return C, c, F, f


# ---------------------------------------------------------------------------
# What one scenario needs, counted from the sources (csrc/riccati.cuh,
# csrc/riccati_blocked.cuh): operations, and dependent operations as floors
# (a division or a square root counts one, a product's sum n in a row).
# ---------------------------------------------------------------------------


def _solve_ops(n: int, k: int) -> int:
    """solve_general_entries on k columns: the elimination, then back
    substitution."""
    ops = 0
    for p in range(n):
        r = n - p - 1
        ops += 1 + r + k + r * (2 * r + 2 * k)
    return ops + k * n * (n - 1)


def _solve_depth(n: int) -> int:
    """Per pivot a reciprocal, the scaled row and the next pivot's update;
    then back substitution, row i waiting on row i+1's n-1-i terms."""
    return 3 * n - 1 + n * (n - 1) // 2


def gains_ops(n: int, m: int) -> int:
    """The free-mode step without its value update: W, Q, q, the factor and
    the gain columns."""
    nm = n + m
    return 2 * n * n * nm + nm * (nm + 1) * n + 2 * n * nm + m * m * m // 3 * 2 + 4 * m + (n + 1) * 2 * m * m


def value_update_ops(n: int, m: int) -> int:
    return 2 * m * n * m + n * (n + 1) // 2 * 6 * m + 6 * n * m


def _gains_depth(n: int, m: int) -> int:
    """W = V F (n), Q = C + F'W (n + 1), the factor and solve (4m)."""
    return 2 * n + 1 + 4 * m


def _step_depth(n: int, m: int) -> int:
    """A serial step: its gains, then the value update through K (2m + 1)."""
    return _gains_depth(n, m) + 2 * m + 1


def _apply_ops(n: int) -> int:
    """V C, V A, A'X (products), V b, A'y, the identity, J, the
    symmetrisation, -v - V b and + eta, and the solve."""
    mm, mv = 2 * n**3, 2 * n * n
    return 3 * mm + 2 * mv + 4 * n * n + 4 * n + _solve_ops(n, n + 1)


def _apply_depth(n: int) -> int:
    """I + V C (n + 1), the solve, A'X + J (n + 1), the symmetrisation (2)."""
    return 2 * n + 4 + _solve_depth(n)


def _combine_ops(n: int) -> int:
    """Six n x n products, four matrix-vector products, the additions and
    symmetrisations, and the two solves (2n + 1 and n + 1 columns)."""
    mm, mv = 2 * n**3, 2 * n * n
    return 6 * mm + 4 * mv + 7 * n * n + 4 * n + _solve_ops(n, 2 * n + 1) + _solve_ops(n, n + 1)


def _combine_depth(n: int) -> int:
    """I + C1 J2 (n + 1), the solve, (P C1) A2' (n), A2 Y + C2 (n + 1), the
    symmetrisation (2)."""
    return 3 * n + 4 + _solve_depth(n)


def _build_ops(n: int, m: int) -> int:
    chol = m * m * m // 3 * 2 + 4 * m
    return chol + (2 * n + 1) * 2 * m * m + (n * n + 2 * n) * (2 * m + 1) + n * (n + 1) // 2 * (4 * m + 1)


def _build_depth(m: int) -> int:
    """The factor and one solve (4m), a column's sum (m), the subtraction."""
    return 5 * m + 1


def sweep_bytes(T: int, B: int, n: int, m: int) -> int:
    """Bytes the unconstrained sweep must move: C's upper triangle, c, F, f in;
    K, k (float32) and free (bool) out."""
    nm = n + m
    return B * T * (4 * (nm * (nm + 1) // 2 + nm + n * nm + n) + 4 * (m * n + m) + m)


def serial_bound(T: int, B: int, n: int, m: int, clock_mhz: float) -> dict:
    ops = B * T * (gains_ops(n, m) + value_update_ops(n, m))
    return bound(sweep_bytes(T, B, n, m), ops, chain_ms(T * _step_depth(n, m), clock_mhz))


def blocked_bound(T: int, B: int, n: int, m: int, D: int, clock_mhz: float) -> dict:
    """Phase 1's T elements, phase 2's T/2 [+ T/4] combines, T/D + T - T/D
    applies and T gain steps; the chain: one element, the tree's levels, the
    T/D - 1 applies before the first block's boundary value, then that
    block's D - 1 applies and its last gains."""
    P, levels = T // D, D.bit_length() - 1
    n_combines = sum(T >> lvl for lvl in range(1, levels + 1))
    ops = B * (T * (_build_ops(n, m) + gains_ops(n, m)) + n_combines * _combine_ops(n) + T * _apply_ops(n))
    depth = _build_depth(m) + levels * _combine_depth(n) + (P - 1 + D - 1) * _apply_depth(n) + _gains_depth(n, m)
    return bound(sweep_bytes(T, B, n, m), ops, chain_ms(depth, clock_mhz))


def _loops(T: int, B: int) -> int:
    return int(min(50, max(5, 2e7 // (T * B))))


def run(parent=None) -> list:
    """The A/B at each of :data:`SHAPES` ``(T, B, n, m, blocks)``: one record
    each. ``vs_serial_held`` says whether every blocked output is within
    ``VS_SERIAL_TOL * max(1, max|serial|)`` of the serial kernel's, and
    ``vs_plain_held`` within ``VS_PLAIN_TOL * max(1, max|plain|)`` of its
    plain version's on the same inputs; the
    first shape's record also has the plain version's time and
    ``launch_host_us``, :func:`launch_host_us` at each D. ``parent``: the root of another checkout whose blocked kernel is
    timed beside (``parent_D<D>``), or None."""
    device = require_card()
    clock = max_sm_clock_mhz()
    tree_rb = None
    if parent:
        from .ab_kkt_lanes import load_tree

        tree_rb = load_tree(parent, "ops.cuda.riccati_blocked")
    records = []
    for i, (T, B, n, m, blocks) in enumerate(SHAPES):
        C, c, F, f = (torch.tensor(a, device=device) for a in make_problem(T, B, n, m, seed=T + B))
        serial = ric.riccati_backward_cuda(C, c, F, f, n)
        vs_serial, vs_plain = {}, {}
        for D in blocks:
            got = rb.riccati_backward_blocked(C, c, F, f, n, block=D)
            vs_serial[f"D{D}"] = _gap(got, serial)
            vs_plain[f"D{D}"] = _gap(got, rb.riccati_backward_blocked_plain(C, c, F, f, n, block=D))
            del got
        stagers = {"serial": (ric._cuda_launcher(device, n, m),
                              lambda launch: ric.run_staged_riccati(launch, C, c, F, f, n))}
        launcher = rb._cuda_launcher(device, n, m)
        for D in blocks:
            stagers[f"blocked_D{D}"] = (launcher, lambda launch, D=D: rb.run_staged_blocked(
                launch, C, c, F, f, n, block=D))
            if tree_rb is not None:
                stagers[f"parent_D{D}"] = (tree_rb._cuda_launcher(device, n, m),
                                           lambda launch, D=D: tree_rb.run_staged_blocked(launch, C, c, F, f, n, block=D))
        ms = interleaved_ms(stagers, N_ROUNDS, _loops(T, B))
        rec = dict(
            T=T, B=B, n=n, m=m, rounds=N_ROUNDS, loops=_loops(T, B), max_sm_clock_mhz=clock, ms=ms,
            serial_over_blocked={f"D{D}": ms["serial"] / ms[f"blocked_D{D}"] for D in blocks},
            vs_serial=vs_serial, vs_serial_tol=VS_SERIAL_TOL, vs_serial_held=_held(vs_serial, VS_SERIAL_TOL),
            vs_plain=vs_plain, vs_plain_tol=VS_PLAIN_TOL, vs_plain_held=_held(vs_plain, VS_PLAIN_TOL),
            bounds=dict(serial=serial_bound(T, B, n, m, clock),
                        **{f"blocked_D{D}": blocked_bound(T, B, n, m, D, clock) for D in blocks}),
        )
        if tree_rb is not None:
            rec["parent_over_blocked"] = {f"D{D}": ms[f"parent_D{D}"] / ms[f"blocked_D{D}"] for D in blocks}
        if i == 0:
            rec["launch_host_us"] = {f"D{D}": launch_host_us(launcher, C, c, F, f, n, D) for D in blocks}
            rec["plain_ms"] = {f"blocked_D{D}": _time_once(lambda D=D: rb.riccati_backward_blocked_plain(
                C, c, F, f, n, block=D)) for D in blocks}
        records.append(rec)
        del C, c, F, f, serial
        torch.cuda.empty_cache()
    return records


PROFILE_PHASES = ("phases 1-2", "phase 3", "phase 4")


def profile(tmp: str) -> list:
    """Cycles of each phase per CTA (thread 0's) at each shape and D, from a
    build of ``csrc/riccati_blocked.cu`` with ``DMPC_BLOCKED_PROFILE`` in
    ``tmp``."""
    device = require_card()
    lib = build.build_with([os.path.join(build.CSRC, "riccati_blocked.cu")], tmp, ("DMPC_BLOCKED_PROFILE=1",),
                           "blocked_profile")
    read = lib.diffmpc_riccati_blocked_profile
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    cycles = (ctypes.c_ulonglong * 4)()
    out = []
    for T, B, n, m, blocks in SHAPES:
        C, c, F, f = (torch.tensor(a, device=device) for a in make_problem(T, B, n, m, seed=T + B))
        fn = getattr(lib, f"diffmpc_riccati_blocked_n{n}m{m}")
        fn.argtypes, fn.restype = [ctypes.POINTER(rb._BlockedArgs), ctypes.c_void_p], ctypes.c_int
        stream = torch.cuda.current_stream(device).cuda_stream

        def launch(args, n, m):
            if fn(args, stream) != 0:
                raise RuntimeError("the profile build's blocked kernel failed to launch")

        for D in blocks:
            torch.cuda.synchronize()
            if read(cycles) != 0:  # cleared
                raise RuntimeError("reading the profile build's cycles failed")
            rb.run_staged_blocked(launch, C, c, F, f, n, block=D)
            torch.cuda.synchronize()
            if read(cycles) != 0:
                raise RuntimeError("reading the profile build's cycles failed")
            ctas = max(1, cycles[3])
            per = {p: cycles[i] / ctas for i, p in enumerate(PROFILE_PHASES)}
            out.append(dict(T=T, B=B, n=n, m=m, block=D, ctas=cycles[3], cycles_per_cta=per,
                            phase_3_share=per["phase 3"] / max(1.0, sum(per.values()))))
        del C, c, F, f
    return out


def launch_host_us(launch, C, c, F, f, n: int, D: int, calls: int = 200) -> float:
    """The host's microseconds a call of the kernel's launcher takes on
    staged inputs after its first (the wrapper's check, the ctypes call and
    the C launcher, its geometry cached; the kernels queued, not waited
    for)."""
    took = []

    def timed(args, n, m):
        launch(args, n, m)
        t0 = time.perf_counter()
        for _ in range(calls):
            launch(args, n, m)
        took.append((time.perf_counter() - t0) / calls * 1e6)

    rb.run_staged_blocked(timed, C, c, F, f, n, block=D)
    torch.cuda.synchronize()
    return took[0]


def _time_once(fn) -> float:
    """One call between CUDA events, after one to warm up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="the root of another checkout whose blocked kernel runs beside")
    parser.add_argument("--profile", action="store_true", help="first count each phase's cycles per CTA")
    opts = parser.parse_args()
    require_card()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    if opts.profile:
        with tempfile.TemporaryDirectory() as tmp:
            for rec in profile(tmp):
                print(json.dumps(dict(profile=True, **rec)), flush=True)
    for rec in run(parent=opts.parent):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
