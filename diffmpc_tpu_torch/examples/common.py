"""What the port's example CLIs share (counterpart of ``examples/common.py``).

- The starts of the envs, drawn with numpy from a seed as the JAX examples
  draw them, so both packages solve the same problems.
- :func:`pick_device`: the card (``cuda:0``, or ``cuda:$LOCAL_RANK`` under
  ``torchrun`` with ``--mesh``), or the CPU with ``--cpu``; without a card
  and without ``--cpu`` it raises, never running on the CPU unasked.
- :func:`train`: the imitation-learning loop every training example runs.
  It makes the expert's controls with the true model, then takes
  ``--steps`` Adam steps of :func:`~diffmpc_tpu_torch.parallel.make_dp_train_step`
  and logs each to ``--out/train.csv``. It saves a checkpoint every
  ``--ckpt-every`` steps (:mod:`diffmpc_tpu_torch.checkpoint`) and resumes
  from the newest with ``--resume``.

``--mesh`` runs the step data-parallel (:mod:`diffmpc_tpu_torch.parallel`).
Under ``torchrun`` each rank joins the group from torchrun's variables.
Run alone, it makes a one-rank group on its device, NCCL on a card and gloo
on the CPU, its rendezvous a ``file://`` store under ``--out``: the
counterpart of the JAX examples' mesh over one device. The starts, the
expert's controls, per-scenario params and the task are sharded on the JAX
scripts' axes; rank 0 writes the log and the checkpoints of replicated
params, and each rank its own shard's where the params are per scenario.
"""

from __future__ import annotations

import argparse
import functools
import os
import time

import numpy as np
import torch

from ..checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..parallel import (
    distributed,
    gather_results,
    generate_expert_data,
    init_train_state,
    make_dp_train_step,
    make_mesh,
    shard_batch,
)
from ..utils.logging import CSVLogger, profile_trace, table_log

COLUMNS = ["step", "loss", "grad_norm", "converged_frac"]  # every train.csv's first columns; "dt" is the last


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.tensor(np.stack(x, -1), dtype=dtype, device=device)


def random_pendulum_x_init(B: int, seed: int = 0, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Swing-up starts: a uniform angle and a speed in [-1, 1]."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, B)
    thdot = rng.uniform(-1.0, 1.0, B)
    return _tensor([np.cos(th), np.sin(th), thdot], dtype, device)


def random_cartpole_x_init(B: int, seed: int = 0, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Near-upright starts (the stabilization task)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-0.5, 0.5, B)
    pdot = rng.uniform(-0.5, 0.5, B)
    th = rng.uniform(-0.3, 0.3, B)
    thdot = rng.uniform(-0.5, 0.5, B)
    return _tensor([p, pdot, np.cos(th), np.sin(th), thdot], dtype, device)


def random_acrobot_x_init(B: int, seed: int = 0, dtype=torch.float32, device="cpu", scale: float = 0.05):
    """Near-upright perturbations of ``scale`` (the balance task)."""
    rng = np.random.default_rng(seed)
    th1 = rng.uniform(-scale, scale, B)
    th2 = rng.uniform(-scale, scale, B)
    return _tensor([np.cos(th1), np.sin(th1), np.cos(th2), np.sin(th2), rng.uniform(-scale, scale, B),
                    rng.uniform(-scale, scale, B)], dtype, device)


def random_vehicle_x_init(B: int, seed: int = 0, dtype=torch.float32, device="cpu", py_scale: float = 1.0):
    """Lane-keeping starts: a lateral offset and a heading error at speed."""
    rng = np.random.default_rng(seed)
    return _tensor([np.zeros(B), rng.uniform(-py_scale, py_scale, B), rng.uniform(-0.3, 0.3, B),
                    rng.uniform(3.0, 7.0, B)], dtype, device)


def add_run_flags(ap: argparse.ArgumentParser, out: str, ckpt_every: int, mesh_help: str) -> None:
    """The flags that close every training example's command line."""
    ap.add_argument("--mesh", action="store_true", help=mesh_help)
    ap.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU")
    ap.add_argument("--out", default=out)
    ap.add_argument("--ckpt-every", type=int, default=ckpt_every, help="save a checkpoint every N steps (0: never)")
    ap.add_argument("--resume", action="store_true", help="continue from the newest checkpoint under --out/ckpt")


def pick_device(args, name: str) -> torch.device:
    """The CPU with ``--cpu``, else the card: ``cuda:$LOCAL_RANK`` under
    torchrun with ``--mesh``, ``cuda:0`` otherwise. Without a card and
    without ``--cpu`` this raises."""
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name} runs on a CUDA card, and none is present: pass --cpu for the CPU")
    rank = int(os.environ.get("LOCAL_RANK", 0)) if getattr(args, "mesh", False) else 0
    return torch.device("cuda", rank)


def open_mesh(args, device):
    """The mesh of ``--mesh`` (module docstring), or None without it."""
    if not args.mesh:
        return None
    if "RANK" in os.environ:  # torchrun
        distributed.initialize(device=device)
    else:
        out = os.path.abspath(args.out)
        os.makedirs(out, exist_ok=True)
        store = os.path.join(out, "mesh_store")
        if os.path.exists(store):
            os.remove(store)  # a store left by an earlier run would hold its keys
        distributed.initialize(f"file://{store}", 1, 0, device=device)
    return make_mesh(device)


def train(args, b: dict, device, *, tag: str, columns=(), row=None, table=None, log_every: int = 10):
    """The imitation loop over the problem ``b`` (an example's ``build``):
    the expert's controls from ``b["cost"]``, ``b["dx"]`` on ``b["x_init"]``
    in the box ``b["lo"]``, ``b["hi"]``, then ``args.steps`` steps of
    Adam(``args.lr``) from ``b["params0"]`` on ``b["make_problem"]``, with
    ``b``'s ``params_batch_axes`` and, where ``b["task"]`` is set, the task
    and its ``task_batch_axes``. Each step appends ``step, loss,
    grad_norm, converged_frac``, then ``row(params)``'s columns (the
    params as host numpy arrays, the whole batch), then ``dt`` to
    ``args.out/train.csv``; every ``log_every`` steps and at the last one it
    prints ``table(i, stats, params, dt)`` under ``tag``. Returns the final
    ``(TrainState, stats, params)``: ``stats`` the last step's as floats
    (None when no step ran), ``params`` the learned params of the whole
    batch as host numpy arrays (under ``--mesh`` the state holds this
    rank's shard)."""
    mesh = open_mesh(args, device)
    try:
        return _train(args, b, mesh, tag, list(columns), row or (lambda p: {}), table, log_every)
    finally:
        if mesh is not None:
            distributed.shutdown()


def _train(args, b, mesh, tag, columns, row, table, log_every):
    config, lo, hi = b["config"], b["lo"], b["hi"]
    t0 = time.perf_counter()
    _, u_expert, expert_objs = generate_expert_data(config, b["cost"], b["dx"], b["x_init"], lo, hi)
    mean_obj = float(expert_objs.mean())  # waits for the card
    print(f"expert data: {b['x_init'].shape[0]} trajectories in {time.perf_counter() - t0:.2f}s, "
          f"mean obj {mean_obj:.4f}")
    batch_axes = b.get("params_batch_axes")
    has_task = b.get("task") is not None
    task_kw = dict(task_batch_axes=b["task_batch_axes"]) if has_task else {}
    optimizer = functools.partial(torch.optim.Adam, lr=args.lr)  # optax.adam(lr)
    step = make_dp_train_step(config, b["make_problem"], optimizer, mesh, u_lower=lo, u_upper=hi,
                              params_batch_axes=batch_axes, **task_kw)
    params0 = b["params0"]
    x_init, task = b["x_init"], (b["task"],) if has_task else ()
    sharded = batch_axes is not None and mesh is not None
    if mesh is not None:
        if sharded:
            params0 = shard_batch(mesh, params0, 0)
        x_init = shard_batch(mesh, x_init, 0)
        u_expert = shard_batch(mesh, u_expert, 1)
        task = tuple(shard_batch(mesh, t, b["task_batch_axes"]) for t in task)
    state = init_train_state(params0, optimizer)
    ckpt_dir = os.path.join(args.out, "ckpt")
    if sharded and mesh.size > 1:
        ckpt_dir = os.path.join(ckpt_dir, f"rank_{mesh.rank}")
    main_rank = mesh is None or mesh.rank == 0
    saves = args.ckpt_every and (main_rank or sharded)
    start = 0
    if args.resume and latest_step(ckpt_dir) is not None:
        start = latest_step(ckpt_dir)
        state = restore_checkpoint(ckpt_dir, state)
        print(f"resumed from step {start}")
    logger = CSVLogger(os.path.join(args.out, "train.csv"), COLUMNS + columns + ["dt"]) if main_rank else None
    stats, params = None, gather_results(state.params, 0 if sharded else None, mesh)
    with profile_trace(getattr(args, "profile_dir", None)):
        for i in range(start, args.steps):
            t1 = time.perf_counter()
            state, out = step(state, x_init, u_expert, *task)
            stats = dict(loss=float(out.loss), grad_norm=float(out.grad_norm),
                         converged_frac=float(out.converged_frac))
            dt = time.perf_counter() - t1
            params = gather_results(state.params, 0 if sharded else None, mesh)
            if main_rank:
                if table is not None and (i % log_every == 0 or i == args.steps - 1):
                    table_log(tag, table(i, stats, params, dt))
                logger.log(step=i, **stats, **row(params), dt=dt)
            if saves and (i + 1) % args.ckpt_every == 0:
                save_checkpoint(ckpt_dir, state, i + 1)
    if logger is not None:
        logger.close()
    return state, stats, params
