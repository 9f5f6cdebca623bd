"""The cost of each piece of the fused iLQR sweep, on the card.

Counterpart of the JAX package's ``scripts/profile_riccati_pieces.py``. The
sweep kernel (``csrc/riccati_pieces.cu``) runs the fused iLQR kernel's
Riccati step on the pendulum ``reps`` times inside one launch, the
repetitions chained by a seed, in five variants: ``full`` and four with one
piece stubbed (``no_lin``: the Jacobian, ``no_Qform``: the Q form,
``no_pnqp``: the box QP and the masked solve, ``no_Vup``: the value update);
the rollout kernel runs a T-step gain-feedback rollout as the cost anchor of
a dependent step. The cost of one sweep is the slope
``(t[reps=9] - t[reps=1]) / 8`` and a piece's cost the ``full`` slope less
its variant's. On the TPU the rep count was compiled into two programs and
the slopes came out negative; here it is a runtime argument of one binary.

Both kernels run as the fused kernel runs its sweep: a group of lanes per
scenario at the fused kernel's rule for the batch
(:func:`~diffmpc_tpu_torch.ops.cuda.riccati_pieces.piece_lanes`), in its two
read modes: ``device`` (each step's inputs loaded from device memory at the
step, as the fused kernel's sweep does) and ``staged`` (copied into the
group's shared memory steps ahead). Each mode of the sweep gets its slopes
and shares; ``load_share_of_full`` is the share of the device-memory
``full`` slope that staging takes off, the loads' latency on the chain
while the repetitions find the inputs in the caches;
``load_share_of_one_sweep`` the same of one sweep's time (reps 1), whose
loads go to device memory. The rollout runs in both modes at the rule's
lanes and at one lane (``rollout_modes``, keyed ``mode@L``: its slope, its
time a step and one rollout's time); ``rollout_load_share_of_one`` is the
share of one rollout's time at the rule's lanes reading device memory that
staging takes off, and ``rollout_slope_share_of_fused_iteration`` each
mode's slope at the rule's lanes over the fused kernel's time an iteration,
where the caller gives it.

Timing: CUDA events around the kernels alone on staged inputs, the
(mode, variant, reps) sweeps and (mode, L, reps) rollouts interleaved in
each of ``N_ROUNDS`` rounds, each one's minimum kept. The inputs are the
script's (:func:`make_inputs`).

Run on a machine with a CUDA device:

    python -m diffmpc_tpu_torch.diagnostics.profile_riccati_pieces

It prints the card's name and power limit, then one JSON record per batch.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from ..models.envs.pendulum import PendulumDx
from ..ops.cuda import riccati_pieces as rp
from .ab_blocked_ilp import gains_ops, value_update_ops
from .card import DEP_OP_CYCLES, bound, chain_ms, interleaved_ms, max_sm_clock_mhz, require_card

T, REPS_HI = 20, 9
BATCHES = (1024, 65536)
N_ROUNDS, LOOPS = 6, 10
KINDS = rp.VARIANTS + ("rollout",)

# Per scenario and step, counted from csrc/riccati_pieces.cuh (the fused
# iLQR kernel's step, csrc/ilqr.cuh) as floors: a division and sin/cos count
# one each. The sweep's chain runs through the value carry: W = V F 3,
# Q = C + F'W 4, the gains (a reciprocal and a product) 2, the value update
# 3; the Jacobian does not wait on it. The rollout's: K (x - x_hat) 3, the
# box clip 2, the pendulum's step 10 (3 u / (m l^2) 2, the g term 1,
# thdot + dt (.) 1, the speed clip 2, dt thdot 1, cos/sin 1, the rotation 2).
# Operations: the
# Jacobian, about 20 scalar operations of the step each carrying 4 tangents
# (~120), the delta cost 32, then the free-mode step's; the rollout's
# control 10, stage cost 44, step 20.
SWEEP_STEP_DEPTH, ROLLOUT_STEP_DEPTH = 12, 15
SWEEP_STEP_OPS = 120 + 32 + gains_ops(3, 1) + value_update_ops(3, 1) + 10
ROLLOUT_STEP_OPS = 10 + 44 + 20
# floats per scenario and step: C (all 16 entries: C tau_hat and the stage
# cost read its rows), c, x_hat, u_hat, lo, hi in; the sweep's K, k out
STEP_FLOATS_IN, SWEEP_FLOATS_OUT = 16 + 4 + 3 + 1 + 1 + 1, 3 + 1


def piece_bound(kind: str, B: int, reps: int, clock_mhz: float, steps: int = T) -> dict:
    """The least time of one launch: the inputs read once and the outputs
    written once (the reps read them again), the operations of every rep, or
    the chain of every rep's dependent steps."""
    if kind == "rollout":
        n_bytes, ops, depth = 4 * B * (steps * STEP_FLOATS_IN + 1), ROLLOUT_STEP_OPS, ROLLOUT_STEP_DEPTH
    else:
        n_bytes, ops, depth = 4 * B * steps * (STEP_FLOATS_IN + SWEEP_FLOATS_OUT), SWEEP_STEP_OPS, SWEEP_STEP_DEPTH
    return bound(n_bytes, reps * steps * B * ops, chain_ms(reps * steps * depth, clock_mhz))


def make_inputs(B: int, device, steps: int = T, seed: int = 0):
    """The script's inputs (``profile_riccati_pieces.py:247-257``): the
    pendulum's goal cost over ``steps``, a random trajectory (``x_hat``
    standard normal, ``u_hat`` half that, drawn in that order from numpy's
    generator), the box +-2, and the pendulum, on ``device``. Returns
    ``(C, c, x_hat, u_hat, u_lower, u_upper, dyn)``."""
    dx = PendulumDx.default(device=device)
    q, p = dx.get_true_obj()
    rng = np.random.default_rng(seed)
    xh = torch.tensor(rng.normal(size=(steps, B, 3)), dtype=torch.float32, device=device)
    uh = torch.tensor(rng.normal(size=(steps, B, 1)) * 0.5, dtype=torch.float32, device=device)
    box = torch.full((steps, B, 1), 2.0, device=device)
    return torch.diag(q).expand(steps, B, 4, 4), p.expand(steps, B, 4), xh, uh, -box, box, dx


MODES = ("device", "staged")


def slopes(ms: dict, prefix: str = "") -> dict:
    """The per-sweep slopes (us), each piece (the ``full`` slope less its
    variant's, us) and its share of ``full``, from ``ms`` keyed
    ``f"{prefix}{kind}@{reps}"``."""
    slope_us = {kind: (ms[f"{prefix}{kind}@{REPS_HI}"] - ms[f"{prefix}{kind}@1"]) / (REPS_HI - 1) * 1e3
                for kind in rp.VARIANTS}
    piece_us = {kind: slope_us["full"] - slope_us[kind] for kind in rp.VARIANTS[1:]}
    return dict(slope_us=slope_us, piece_us=piece_us,
                piece_share_of_full={k: v / slope_us["full"] for k, v in piece_us.items()},
                full_step_ns=slope_us["full"] / T * 1e3)


def rollout_key(mode: str, lanes: int, reps: int) -> str:
    return f"rollout:{mode}@{lanes}:{reps}"


def rollout_modes(ms: dict, lane_counts) -> dict:
    """The rollout's slope (us a rollout), time a step (ns) and one
    rollout's time (ms, reps 1) in each read mode at each of
    ``lane_counts``, from ``ms`` keyed by :func:`rollout_key`, keyed
    ``mode@L``."""
    out = {}
    for mode in MODES:
        for lanes in lane_counts:
            slope = (ms[rollout_key(mode, lanes, REPS_HI)] - ms[rollout_key(mode, lanes, 1)]) / (REPS_HI - 1) * 1e3
            out[f"{mode}@{lanes}"] = dict(slope_us=slope, rollout_step_ns=slope / T * 1e3,
                                          one_ms=ms[rollout_key(mode, lanes, 1)])
    return out


def run(ilqr_ms_per_iter: float | None = None) -> list:
    """The slopes and pieces at each of :data:`BATCHES`, the sweep at the
    rule's lane count in both read modes, the rollout in both at the rule's
    lane count and at one lane: one record each. ``ilqr_ms_per_iter``: the
    fused kernel's time an iteration at the first batch, the yardstick of
    the rollout's slope there."""
    device = require_card()
    clock = max_sm_clock_mhz()
    launcher = rp._cuda_launcher(device)
    records = []
    for B in BATCHES:
        ins = make_inputs(B, device)
        lanes = rp.piece_lanes(B, ins[-1], device)
        stagers = {
            f"{mode}:{kind}@{reps}": (launcher, lambda launch, kind=kind, reps=reps, staged=mode == "staged":
                                      rp.run_staged_pieces(launch, kind, *ins, reps=reps, lanes=lanes, staged=staged))
            for mode in MODES for kind in rp.VARIANTS for reps in (1, REPS_HI)
        }
        lane_counts = tuple(dict.fromkeys((lanes, 1)))
        for mode in MODES:
            for L in lane_counts:
                for reps in (1, REPS_HI):
                    stagers[rollout_key(mode, L, reps)] = (
                        launcher, lambda launch, reps=reps, L=L, staged=mode == "staged": rp.run_staged_pieces(
                            launch, "rollout", *ins, reps=reps, lanes=L, staged=staged))
        ms = interleaved_ms(stagers, N_ROUNDS, LOOPS)
        modes = {mode: slopes(ms, f"{mode}:") for mode in MODES}
        roll = rollout_modes(ms, lane_counts)
        full = {mode: modes[mode]["slope_us"]["full"] for mode in MODES}
        at_pick = {mode: roll[f"{mode}@{lanes}"] for mode in MODES}
        records.append(dict(
            B=B, T=T, lanes=lanes, reps=(1, REPS_HI), rounds=N_ROUNDS, loops=LOOPS, ms=ms, modes=modes,
            rollout_modes=roll,
            rollout_load_share_of_one=(at_pick["device"]["one_ms"] - at_pick["staged"]["one_ms"])
            / at_pick["device"]["one_ms"],
            rollout_slope_share_of_fused_iteration={
                mode: r["slope_us"] * 1e-3 / ilqr_ms_per_iter for mode, r in at_pick.items()}
            if ilqr_ms_per_iter and B == BATCHES[0] else None,
            load_share_of_full=(full["device"] - full["staged"]) / full["device"],
            # one sweep alone reads its inputs cold; the reps' slope reads them from the caches
            load_share_of_one_sweep=(ms["device:full@1"] - ms["staged:full@1"]) / ms["device:full@1"],
            full_step_chain_ns=SWEEP_STEP_DEPTH * DEP_OP_CYCLES / clock * 1e3,
            bounds={f"{kind}@{reps}": piece_bound(kind, B, reps, clock) for kind in ("full", "rollout")
                    for reps in (1, REPS_HI)},
        ))
        del ins
        torch.cuda.empty_cache()
    return records


def main() -> None:
    require_card()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    for rec in run():
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
