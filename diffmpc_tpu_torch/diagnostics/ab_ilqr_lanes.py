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

Run on a machine with a CUDA device:

    python -m diffmpc_tpu_torch.diagnostics.ab_ilqr_lanes [--batches 1024 65536]

It prints the card's name and power limit, then one JSON record per shape.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

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


def run(device, cases: list, rounds: int = 3, loops: int = 3, lanes=il.ILQR_LANES) -> list:
    """One record per case of :func:`shapes`; raises where an L is not bit
    for bit the L = 1 kernel on every scenario."""
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
        outs = {L: stage(launcher) for L, (launcher, stage) in stagers.items()}
        share = {L: bit_equal_share(outs[L], outs[1]) for L in lanes}
        ms = interleaved_ms(stagers, rounds, loops if B <= 4096 else max(1, loops // 2))
        pick = il.ilqr_lanes(B, env, sm_count, hoist)
        records.append(dict(
            env=label, B=B, T=T, hoist_lin=hoist, **knobs, sm_count=sm_count, pick=pick,
            bit_equal_share=share, ms=ms, pick_over_one=ms[pick] / ms[1] if pick in ms else None,
            max_n_iters=int(outs[1].n_iters.max()),
        ))
        if min(share.values()) < 1.0:
            raise AssertionError(f"lanes A/B: a lane count is not bit for bit one lane: {records[-1]}")
        del outs
        torch.cuda.empty_cache()
    return records


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", type=int, nargs="+", default=[1024, 1000, 65536])
    parser.add_argument("--nn-batches", type=int, nargs="+", default=[1024, 65536])
    opts = parser.parse_args()
    device = require_card()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    for rec in run(device, shapes(device, opts.batches, opts.nn_batches)):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
