"""The callable-cost artifact's problem, and the ranks' side of
tests/test_torch_aot_callable.py's mesh test: a helper module, like
tests/torch_dist_cases.py.

tests/test_mpc.py:160's cosh cost (a goal quadratic with weights ``Q`` and a
cosh barrier on the control) on the float64 pendulum, box +-2, at T=5 and
B=8, its starts drawn with numpy from a seed.

Imports torch and numpy only: the spawned ranks import it.
"""

import numpy as np
import torch

import diffmpc_tpu_torch as tdm
from diffmpc_tpu_torch import aot
from diffmpc_tpu_torch.models import PendulumDx

B, T = 8, 5
BOX = dict(u_lower=-2.0, u_upper=2.0)
GOAL = np.array([1.0, 0.0, 0.0, 0.0])
Q = np.array([1.0, 1.0, 0.1, 0.001])


def torch_cost(q):
    """The cosh cost in torch, closing over ``q`` and the goal."""
    goal = torch.tensor(GOAL, dtype=q.dtype)

    def cost_fn(tau):
        d = tau - goal
        return 0.5 * (q * d * d).sum() + 0.01 * (torch.cosh(tau[3:]) - 1.0).sum()

    return cost_fn


def x_init(seed=31) -> np.ndarray:
    """Swing-up starts: a uniform angle and a speed in [-1, 1]."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, B)
    return np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, B)], -1)


def config(lqr_iter=4, **kw) -> tdm.MPCConfig:
    return tdm.MPCConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=lqr_iter, eps=1e-6, exit_unconverged=False,
                         detach_unconverged=False, **kw)


def problem(lqr_iter=4, **kw):
    """``(config, cost, dx, x)`` of the port, float64 on the CPU."""
    return (config(lqr_iter, **kw), torch_cost(torch.tensor(Q)), PendulumDx.default(torch.float64, device="cpu"),
            torch.tensor(x_init()))


def rank_mesh_artifact(mesh) -> dict:
    """One rank: the cosh-cost artifact exported under ``mesh=``, loaded and
    called on this rank's shard, against the live solve of the same shard."""
    cfg, cost, dx, x = problem(lqr_iter=1)
    blob = aot.export_solve(cfg, cost, dx, B, mesh=mesh, **BOX)
    shard = x.chunk(mesh.size)[mesh.rank]
    got = aot.load_solve(blob)(shard)
    with torch.no_grad():
        want = tdm.mpc_solve(cfg, shard, cost, dx, **BOX)
    return dict(mesh=aot.read_manifest(blob)["mesh"], shape=list(aot.read_manifest(blob)["inputs"][0]["shape"]),
                xs=torch.equal(got.xs, want.xs), us=torch.equal(got.us, want.us),
                objs=torch.equal(got.objs, want.objs), n_iters=int(got.info.n_iters),
                live_n_iters=int(want.info.n_iters))
