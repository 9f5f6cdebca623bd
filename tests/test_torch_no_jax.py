"""The PyTorch port imports torch and never JAX, not even indirectly.

In a fresh interpreter where ``import jax`` fails, every module of
``diffmpc_tpu_torch`` imports (the non-fused path's and the dynamics
zoo's among them, by name), and the fused and the non-fused solve run on
the CPU, on the pendulum, a ``LinDx``, a small and a large MLP,
``AffineDynamics`` and each env of the zoo, and a receding-horizon episode
with a callable cost and the slew penalty runs, and so does a training
example with a checkpoint saved and restored. No module of the port
imports optax or Orbax. The chip smoke script
imports no JAX either, and refuses to run without a card.
"""

import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np
import torch
import diffmpc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(diffmpc_tpu_torch.__path__, "diffmpc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
new = ["ops.cuda.riccati", "ops.cuda.rollout", "ops.pnqp", "ops.smallchol", "ops.lqr", "ops.lqr_step",
       "ops.cuda.horizon", "ops.cuda.riccati_stream", "ops.cuda.rollout_stream", "ops.cuda.kkt_stream",
       "ops.assoc_riccati", "ops.cuda.riccati_blocked", "ops.cuda.riccati_pieces", "diagnostics.card",
       "diagnostics.ab_blocked_ilp", "diagnostics.profile_riccati_pieces", "diagnostics.ab_nn_reread",
       "models.dynamics", "parallel.training", "convert", "parallel.mesh", "parallel.distributed",
       "parallel.dryrun", "ops.cuda.shard_probe", "utils.tree", "models.envs.cartpole", "models.envs.vehicle",
       "models.envs.quadrotor", "models.envs.acrobot", "receding", "utils.logging", "utils.debug",
       "examples.receding_mpc", "checkpoint", "examples.common", "examples.gen_expert_data", "examples.il_pendulum",
       "examples.il_cartpole", "examples.il_vehicle", "examples.il_quadrotor", "examples.il_acrobot",
       "examples.il_nn_dynamics", "examples.sysid_domain_rand"]
assert all(f"diffmpc_tpu_torch.{m}" in names for m in new), names
assert "diffmpc_tpu" not in sys.modules and "jax" in sys.modules
assert not any(m.split(".")[0] in ("optax", "orbax", "flax") for m in sys.modules)
from diffmpc_tpu_torch.models import PendulumDx
from diffmpc_tpu_torch.ops.cuda.ilqr import ilqr_solve_plain
B, T = 16, 5
rng = np.random.default_rng(0)
th = rng.uniform(-np.pi, np.pi, B)
x = torch.tensor(np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, B)], -1), dtype=torch.float32)
dx = PendulumDx.default(device="cpu")
q, p = dx.get_true_obj()
out = ilqr_solve_plain(
    x, torch.diag(q).expand(T, B, 4, 4), p.expand(T, B, 4), dx,
    torch.full((T, B, 1), -2.0), torch.full((T, B, 1), 2.0), lqr_iter=2,
)
assert bool(torch.isfinite(out.objs).all()) and out.us.abs().max() <= 2.0
from diffmpc_tpu_torch import LinDx, MPCConfig, QuadCost, mpc_solve
n, m = 4, 2
sol = mpc_solve(
    MPCConfig(n_state=n, n_ctrl=m, T=T, lqr_iter=3, exit_unconverged=False),
    torch.ones(B, n), QuadCost(torch.eye(n + m), torch.ones(n + m)),
    LinDx(0.5 * torch.eye(n, n + m), None), u_lower=-0.6, u_upper=0.6,
)
assert bool(torch.isfinite(sol.objs).all()) and sol.us.abs().max() <= 0.6
from diffmpc_tpu_torch.models import AffineDynamics, NNDynamics
cfg = MPCConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=2, exit_unconverged=False)
gen = torch.Generator().manual_seed(0)
for model in (NNDynamics.init(3, 1, hidden=(8,), residual=True, device="cpu", generator=gen),
              NNDynamics.init(3, 1, hidden=(40,), residual=True, device="cpu", generator=gen),
              AffineDynamics(0.9 * torch.eye(3), torch.ones(3, 1))):
    sol = mpc_solve(cfg, 0.1 * x, QuadCost(torch.diag(q), p), model, u_lower=-2.0, u_upper=2.0)
    assert bool(torch.isfinite(sol.objs).all()) and sol.us.abs().max() <= 2.0
from diffmpc_tpu_torch.models import AcrobotDx, CartpoleDx, QuadrotorDx, VehicleDx
starts = {CartpoleDx: [0.1, 0.0, 1.0, 0.0, 0.0], VehicleDx: [0.0, 0.5, 0.0, 5.0], QuadrotorDx: [0.1] * 6,
          AcrobotDx: [1.0, 0.0, 1.0, 0.0, 0.0, 0.0]}
for model, start in starts.items():
    dx = model.default(device="cpu")
    n, m = dx.n_state, dx.n_ctrl
    q, p = dx.get_true_obj()
    sol = mpc_solve(MPCConfig(n_state=n, n_ctrl=m, T=T, lqr_iter=1, exit_unconverged=False),
                    torch.tensor(start).expand(B, n), QuadCost(torch.diag(q), p), dx, u_lower=0.0, u_upper=1.0)
    assert bool(torch.isfinite(sol.objs).all()) and sol.us.abs().max() <= 1.0
from diffmpc_tpu_torch.receding import run_receding_horizon
dx = PendulumDx.default(device="cpu")
q, p = dx.get_true_obj()
cfg = MPCConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=2, exit_unconverged=False, slew_rate_penalty=0.5)
xs, us, objs = run_receding_horizon(cfg, x, lambda tau: ((tau - 0.1) ** 2).sum(), dx, 2, u_lower=-2.0, u_upper=2.0)
assert xs.shape == (3, B, 3) and bool(torch.isfinite(objs).all()) and us.abs().max() <= 2.0
import tempfile
from diffmpc_tpu_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from diffmpc_tpu_torch.examples import il_pendulum
with tempfile.TemporaryDirectory() as out:
    flags = ["--cpu", "--batch", "4", "--horizon", "3", "--lqr-iter", "1", "--ckpt-every", "1", "--out", out]
    state = il_pendulum.main(flags + ["--steps", "1"])
    assert latest_step(out + "/ckpt") == 1
    restore_checkpoint(out + "/ckpt", state)
print("modules", len(names))
"""


def test_port_imports_and_solves_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 16  # every module was imported


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_no_port_file_names_jax():
    """No module of the port, and not chip_smoke.py, imports JAX, the JAX
    package or anything under scripts/ (every script there imports JAX)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "diffmpc_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "orbax", "diffmpc_tpu", "__graft_entry__",
                               "scripts"), (
                path, mod,
            )


def test_chip_smoke_refuses_to_run_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=env,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
