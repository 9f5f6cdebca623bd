"""The data-parallel cases of the port's tests, and the ranks' side of
tests/test_torch_distributed.py: a helper module, like tests/torch_parity.py.

The float64 recipes of tests/test_sharding.py:22-45 and :297-413 (the
pendulum, eps=0 and ``not_improved_lim=10**6`` so that every scenario runs
every iteration and no branch sits near a tie), cut to B=16, T=6,
``lqr_iter=2``, one SGD step at 1e-2. (At ``lqr_iter=3`` scenario 7 of the
task configuration has converged to float64 noise, and its last line search
is decided by an ulp: the port backtracks to alpha 5.1e-7 where JAX takes 1,
at objectives 1.8e-15 apart.)

- ``replicated``: the shared params (10, 1, 1);
- ``per_scenario``: per-scenario rows, ``params_batch_axes=0``;
- ``mixed``: ``{"dyn": rows, "bias": shared}``, axes ``{"dyn": 0, "bias": None}``;
- ``task``: shared params and a per-scenario goal cost vector
  ``(T, B, 4)``, ``task_batch_axes=1``.

Imports torch and numpy only: the spawned ranks import it, and the card's
tests take ``world_one_mesh`` from it.
"""

import contextlib
import functools

import numpy as np
import torch

import diffmpc_tpu_torch as tdm
from diffmpc_tpu_torch.models import PendulumDx
from diffmpc_tpu_torch.ops.assoc_riccati import riccati_backward_time_sharded
from diffmpc_tpu_torch.ops.cuda.shard_probe import shard_probe
from diffmpc_tpu_torch.parallel import (
    dryrun,
    gather_results,
    init_train_state,
    make_dp_train_step,
    make_mesh,
    replicate,
    shard_batch,
)
from diffmpc_tpu_torch.parallel import distributed
from diffmpc_tpu_torch.parallel.distributed import host_local_to_global
from diffmpc_tpu_torch.utils.tree import tree_map

B, T, LQR_ITER = 16, 6, 2
CONFIGS = ("replicated", "per_scenario", "mixed", "task")
KNOBS = dict(n_state=3, n_ctrl=1, T=T, lqr_iter=LQR_ITER, eps=0.0, not_improved_lim=10**6,
             exit_unconverged=False, detach_unconverged=False)
TRUE = np.array([10.0, 1.0, 1.0])


def inputs() -> dict:
    """The numpy inputs of every configuration (seeds of the JAX tests)."""
    rng = np.random.default_rng(50)
    th = rng.uniform(-np.pi, np.pi, B)
    x = np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, B)], -1)
    thg = np.random.default_rng(55).uniform(-0.4, 0.4, B)
    goal = np.stack([np.cos(thg), np.sin(thg), 0 * thg, 0 * thg], -1)
    q, _ = PendulumDx.default(torch.float64, device="cpu").get_true_obj()
    return dict(
        x=x, u=np.zeros((T, B, 1)),
        params=dict(
            replicated=TRUE,
            per_scenario=TRUE * np.random.default_rng(53).uniform(0.9, 1.1, (B, 3)),
            mixed=dict(dyn=TRUE * np.random.default_rng(54).uniform(0.9, 1.1, (B, 3)),
                       bias=np.array([0.1, -0.05, 0.02])),
            task=TRUE,
        ),
        task=np.ascontiguousarray(np.broadcast_to(-goal * q.numpy(), (T, B, 4))),
    )


@contextlib.contextmanager
def world_one_mesh(tmp_dir, axis="batch", device="cpu"):
    """A process group of this process alone (gloo on the CPU, NCCL on a
    card; the rendezvous a ``file://`` store in ``tmp_dir``) and its 1-D
    mesh named ``axis``; the group is left on exit."""
    distributed.initialize(f"file://{tmp_dir}/store", 1, 0, device=device)
    try:
        yield make_mesh(axis=axis)
    finally:
        distributed.shutdown()


AXES = dict(replicated=None, per_scenario=0, mixed=dict(dyn=0, bias=None), task=None)


def port_step(name: str, data: dict, mesh=None) -> dict:
    """One step of configuration ``name`` with the port, on this rank's
    shards when a mesh is given; the stats and the params (the batched
    leaves gathered) as numpy."""
    dx = PendulumDx.default(torch.float64, device="cpu")
    q, p = dx.get_true_obj()
    cost = tdm.QuadCost(torch.diag(q), p)
    if name == "mixed":
        make_problem = lambda prm: (cost, dx.replace(params=prm["dyn"] + prm["bias"]))  # noqa: E731
    elif name == "task":
        make_problem = lambda prm, task: (tdm.QuadCost(cost.C, task), dx.replace(params=prm))  # noqa: E731
    else:
        make_problem = lambda prm: (cost, dx.replace(params=prm))  # noqa: E731
    kw = dict(task_batch_axes=1) if name == "task" else {}
    sgd = functools.partial(torch.optim.SGD, lr=1e-2)
    step = make_dp_train_step(tdm.MPCConfig(**KNOBS), make_problem, sgd, mesh, -2.0, 2.0,
                              params_batch_axes=AXES[name], **kw)
    params = tree_map(torch.tensor, data["params"][name])
    x, u, task = (torch.tensor(data[k]) for k in ("x", "u", "task"))
    if mesh is not None:
        if AXES[name] == 0:
            params = shard_batch(mesh, params)
        elif name == "mixed":
            params = dict(dyn=shard_batch(mesh, params["dyn"]), bias=params["bias"])
        x, u, task = shard_batch(mesh, x), shard_batch(mesh, u, 1), shard_batch(mesh, task, 1)
    state, stats = step(init_train_state(params, sgd), x, u, *([task] if name == "task" else []))
    out = {k: float(v) for k, v in stats._asdict().items()}
    out["params"] = gather_results(state.params, AXES[name], mesh)
    return out


def _error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def rank_cases(mesh, data: dict, problems: list, spec: dict) -> dict:
    """Every case of tests/test_torch_distributed.py on this rank."""
    out = dict(steps={name: port_step(name, data, mesh) for name in CONFIGS})
    out["gather"] = gather_results(dict(x=shard_batch(mesh, data["x"]), u=shard_batch(mesh, data["u"], 1)),
                                   dict(x=0, u=1), mesh)
    time_mesh = make_mesh(axis="time")
    out["riccati"] = []
    for C, c, F, f, n in problems:
        res = riccati_backward_time_sharded(time_mesh, *shard_batch(time_mesh, (C, c, F, f), 0), n)
        out["riccati"].append(gather_results((res.K, res.k), 0, time_mesh))
    C, c, F, f, n = problems[0]
    out["riccati_uneven"] = _error(lambda: shard_batch(time_mesh, tuple(a[:5] for a in (C, c, F, f)), 0))
    out["riccati_wrong_axis"] = _error(lambda: riccati_backward_time_sharded(
        mesh, *shard_batch(mesh, (C, c, F, f), 0), n))
    out["uneven_shard"] = _error(lambda: shard_batch(mesh, data["x"][:15]))
    out["host_local"] = tuple(host_local_to_global(mesh, data["x"][mesh.rank::2], 0).shape)
    out["host_local_mismatch"] = _error(lambda: host_local_to_global(mesh, data["x"][: mesh.rank + 1], 0))
    out["replicate"] = replicate(mesh, torch.full((3,), float(mesh.rank) + 1.0)).numpy()
    out["probe"] = gather_results(shard_probe(shard_batch(mesh, torch.arange(16, dtype=torch.float32) ** 1.5)),
                                  0, mesh)
    out["dryrun"] = dryrun.rank_dryrun(mesh, spec)
    return out
