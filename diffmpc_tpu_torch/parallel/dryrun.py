"""A data-parallel dry run over N ranks (counterpart of ``__graft_entry__.dryrun_multichip``, its phases 1-3).

    python -m diffmpc_tpu_torch.parallel.dryrun                 # 2 ranks sharing the card (gloo)
    python -m diffmpc_tpu_torch.parallel.dryrun --device cpu --batch 64 --il-batch 32 --horizon 8 --lqr-iter 3

:func:`run` spawns the ranks (the ``spawn`` start method, so a parent that
has initialised CUDA may spawn; the rendezvous is a ``file://`` store in a
temporary directory). Each rank (:func:`rank_dryrun`), on its own shard:

1. the probe kernel (:mod:`~diffmpc_tpu_torch.ops.cuda.shard_probe`) on its
   shard of ``arange(16) ** 1.5`` (the JAX test's ``(16,)`` array);
2. one data-parallel step of the pendulum ensemble with per-scenario params
   (BASELINE.json config 5, the recipe of tests/test_sharding.py:121-175:
   params = true * (1 + 0.05 N(0, 1)) with ``params_batch_axes=0``, SGD 1e-2,
   ``u_expert = 0``, T=20, ``lqr_iter=10``, box +-2);
3. the fused forward solve of its shard;
4. steps of the imitation recipe with replicated params (Adam 5e-2 from
   (8, 1.25, 0.8), the expert solved with the true (10, 1, 1));
5. :func:`~.mesh.gather_results` of its shard of the initial states;
6. the sharded serving artifact (``__graft_entry__.py:159-184``): the fused
   solve of step 3 exported with ``mesh=`` (each rank's program at
   ``B / world``, :func:`~diffmpc_tpu_torch.aot.export_solve`), loaded and
   called on the rank's shard, its ``objs`` held bit for bit to the live
   solve of the same shard; and the same with the ensemble's per-scenario
   params as the program's input (``params_input=True``), each rank
   passing its own rows.

The parent runs the same problems in one process on the same device
(:func:`single_process`) and :func:`check` holds the ranks to it. On a card
each rank times its steps by CUDA events; two ranks that share one card are
two processes taking turns on it, not a scaling measurement. NCCL refuses
two ranks on one card, so they take gloo there.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import queue
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp

from .. import MPCConfig, QuadCost, mpc_solve
from ..aot import export_solve, load_solve, read_manifest
from ..models import PendulumDx
from ..ops.cuda.ilqr import ilqr_solve_fused
from ..ops.cuda.kkt import kkt_backward_fused
from ..diagnostics.card import cuda_ms
from ..ops.cuda.shard_probe import shard_probe, shard_probe_cuda, shard_probe_plain
from ..utils.tree import tree_map
from . import distributed
from .mesh import gather_results, make_mesh, shard_batch
from .training import generate_expert_data, init_train_state, make_dp_train_step

TRUE_PARAMS, IL_PARAMS0 = (10.0, 1.0, 1.0), (8.0, 1.25, 0.8)
EPS, BOX, PROBE_LEN = 1e-5, 2.0, 16
TIME_LOOPS = 5  # steps per timed loop on a card (best of three loops)
RANK_TIMEOUT_S = 900.0
KERNELS = dict(ilqr=ilqr_solve_fused, kkt=kkt_backward_fused, probe=shard_probe_cuda)


def _x_init(rng, B: int) -> np.ndarray:
    """Swing-up starts: a random angle, a speed in [-1, 1]."""
    th = rng.uniform(-np.pi, np.pi, B)
    return np.stack([np.cos(th), np.sin(th), rng.uniform(-1.0, 1.0, B)], -1)


def _configs(spec: dict):
    ensemble = MPCConfig(n_state=3, n_ctrl=1, T=spec["T"], lqr_iter=spec["lqr_iter"], eps=EPS,
                         exit_unconverged=False, detach_unconverged=False)
    return ensemble, dataclasses.replace(ensemble, detach_unconverged=True)


def _pendulum(device):
    dx = PendulumDx.default(device=device)
    q, p = dx.get_true_obj()
    return dx, QuadCost(torch.diag(q), p)


def make_spec(device, B: int = 65536, T: int = 20, lqr_iter: int = 10, il_batch: int = 1024,
              il_steps: int = 3) -> dict:
    """The dry run's inputs, float32 numpy arrays made from seed 0; the
    imitation expert's controls come from a solve on ``device``."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    spec = dict(T=T, lqr_iter=lqr_iter, il_steps=il_steps, probe=np.arange(PROBE_LEN, dtype=f32) ** 1.5,
                x=_x_init(rng, B).astype(f32),
                params=(np.asarray(TRUE_PARAMS) * (1.0 + 0.05 * rng.standard_normal((B, 3)))).astype(f32),
                x_il=_x_init(rng, il_batch).astype(f32))
    _, il_config = _configs(spec)
    dx, cost = _pendulum(device)
    _, u_il, _ = generate_expert_data(il_config, cost, dx, torch.tensor(spec["x_il"], device=device), -BOX, BOX)
    spec["u_il"] = u_il.cpu().numpy()
    return spec


def _counts() -> dict:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {name: fn.launches for name, fn in KERNELS.items()}


def _reset() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _stats(stats) -> dict:
    return {k: float(v) for k, v in stats._asdict().items()}


def _local(mesh, device, tree, batch_dim: int = 0):
    """``tree``'s shard on ``mesh``, or the whole of it on ``device``."""
    if mesh is not None:
        return shard_batch(mesh, tree, batch_dim)
    return tree_map(lambda a: torch.as_tensor(a).to(device), tree)


def ensemble_step(spec: dict, device, mesh):
    """Config 5's step with per-scenario params, on ``mesh``'s shards or, with
    None, on the whole batch: ``(step, state, x, u)``."""
    config, _ = _configs(spec)
    x, params = _local(mesh, device, (spec["x"], spec["params"]))
    u = torch.zeros((spec["T"], x.shape[0], 1), device=device)
    dx, cost = _pendulum(device)
    sgd = functools.partial(torch.optim.SGD, lr=1e-2)
    step = make_dp_train_step(config, lambda p: (cost, dx.replace(params=p)), sgd, mesh, -BOX, BOX,
                              params_batch_axes=0)
    return step, init_train_state(params, sgd), x, u


def _timed(device) -> bool:
    return torch.device(device).type == "cuda"


def _ensemble(spec, device, mesh) -> dict:
    """One step of config 5's ensemble, with its launches (and, on a card,
    its time)."""
    step, state, x, u = ensemble_step(spec, device, mesh)
    _reset()
    state, stats = step(state, x, u)
    out = dict(launches=_counts(), **_stats(stats))
    out["params"] = gather_results(state.params, 0, mesh)
    if _timed(device):
        out["step_ms"] = cuda_ms(lambda: step(state, x, u), TIME_LOOPS)
    return out


def _solve(spec, device, mesh) -> dict:
    """The fused forward solve of the ensemble's states with the true params."""
    config, _ = _configs(spec)
    x = _local(mesh, device, spec["x"])
    dx, cost = _pendulum(device)
    _reset()
    with torch.no_grad():
        sol = mpc_solve(config, x, cost, dx, u_lower=-BOX, u_upper=BOX)
    out = dict(launches=_counts())
    out["us"], out["objs"] = gather_results((sol.us, sol.objs), (1, 0), mesh)
    return out


def _artifact(spec, device, mesh) -> dict:
    """Step 3's solve as the sharded artifact: exported with ``mesh=``,
    loaded, called on this rank's shard (its launches counted) and held to
    the live solve of the same shard; then the same with the ensemble's
    per-scenario params as the program's input, this rank's rows passed."""
    config, _ = _configs(spec)
    x = _local(mesh, device, spec["x"])
    dx, cost = _pendulum(device)
    t0 = time.perf_counter()
    blob = export_solve(config, cost, dx, len(spec["x"]), u_lower=-BOX, u_upper=BOX, mesh=mesh)
    export_s = time.perf_counter() - t0
    solve = load_solve(blob)
    _reset()
    got = solve(x)
    launches = _counts()
    with torch.no_grad():
        want = mpc_solve(config, x, cost, dx, u_lower=-BOX, u_upper=BOX)
    # the ensemble's per-scenario params as the program's input, each rank
    # passing its own rows
    rows = _local(mesh, device, spec["params"])
    per_scenario = export_solve(config, cost, dx.replace(params=torch.as_tensor(spec["params"], device=device)),
                                len(spec["x"]), u_lower=-BOX, u_upper=BOX, params_input=True, mesh=mesh)
    solve_rows = load_solve(per_scenario)
    _reset()
    got_rows = solve_rows(x, rows)
    rows_launches = _counts()
    with torch.no_grad():
        want_rows = mpc_solve(config, x, cost, dx.replace(params=rows), u_lower=-BOX, u_upper=BOX)
    return dict(form=read_manifest(blob)["mesh"]["form"], bytes=len(blob), export_s=export_s, launches=launches,
                objs_bit_equal=bool(torch.equal(got.objs, want.objs)), us_bit_equal=bool(torch.equal(got.us, want.us)),
                n_iters=int(got.info.n_iters), live_n_iters=int(want.info.n_iters),
                params_form=read_manifest(per_scenario)["mesh"]["form"], params_launches=rows_launches,
                params_objs_bit_equal=bool(torch.equal(got_rows.objs, want_rows.objs)),
                params_us_bit_equal=bool(torch.equal(got_rows.us, want_rows.us)),
                params_n_iters=int(got_rows.info.n_iters), params_live_n_iters=int(want_rows.info.n_iters))


def imitation_step(spec: dict, device, mesh):
    """The imitation recipe's step, params replicated: ``(step, state, x, u)``."""
    _, config = _configs(spec)
    x = _local(mesh, device, spec["x_il"])
    u = _local(mesh, device, spec["u_il"], 1)
    dx, cost = _pendulum(device)
    adam = functools.partial(torch.optim.Adam, lr=5e-2)
    step = make_dp_train_step(config, lambda p: (cost, dx.replace(params=p)), adam, mesh, -BOX, BOX)
    return step, init_train_state(torch.tensor(IL_PARAMS0, device=device), adam), x, u


def all_reduce_ms(mesh, loops: int) -> float:
    """The imitation step's one collective alone (its three gradients and
    five scalars), by CUDA events."""
    buf = torch.zeros(8, device=mesh.device)
    dist.all_reduce(buf, group=mesh.group)
    return cuda_ms(lambda: dist.all_reduce(buf, group=mesh.group), loops)


def _imitation(spec, device, mesh) -> dict:
    """``il_steps`` steps of the imitation recipe, with their launches."""
    step, state, x, u = imitation_step(spec, device, mesh)
    out = dict(steps=[])
    _reset()
    for _ in range(spec["il_steps"]):
        state, stats = step(state, x, u)
        out["steps"].append(dict(**_stats(stats), params=state.params.detach().cpu().numpy()))
    out["launches"] = _counts()
    if _timed(device):
        out["step_ms"] = cuda_ms(lambda: step(state, x, u), TIME_LOOPS)
        out["all_reduce_ms"] = all_reduce_ms(mesh, 10 * TIME_LOOPS) if mesh is not None else None
    return out


def rank_dryrun(mesh, spec: dict) -> dict:
    """One rank's part of the dry run (module docstring), on ``mesh.device``.
    Every rank gathers; rank 0's record holds the gathered batches."""
    device = mesh.device
    x = shard_batch(mesh, torch.tensor(spec["probe"]))
    _reset()
    probe = shard_probe(x)
    rec = dict(rank=mesh.rank, world=mesh.size, backend=dist.get_backend(mesh.group), device=str(device),
               probe=dict(launches=_counts(), out=gather_results(probe, 0, mesh)))
    rec["ensemble"] = _ensemble(spec, device, mesh)
    rec["solve"] = _solve(spec, device, mesh)
    rec["imitation"] = _imitation(spec, device, mesh)
    rec["gather"] = gather_results(shard_batch(mesh, spec["x"]), 0, mesh)
    rec["artifact"] = _artifact(spec, device, mesh)
    if mesh.rank != 0:
        for part, key in (("probe", "out"), ("ensemble", "params"), ("solve", "us"), ("solve", "objs")):
            rec[part][key] = None
        rec["gather"] = None
    return rec


def single_process(spec: dict, device) -> dict:
    """The same problems in this process on ``device``, without a mesh."""
    return dict(ensemble=_ensemble(spec, device, None), solve=_solve(spec, device, None),
                imitation=_imitation(spec, device, None))


def check(ranks: list, single: dict, spec: dict) -> dict:
    """Hold the ranks' records to the single process's; raises
    ``AssertionError`` naming what disagrees. One rank must equal it
    exactly (its collectives are the identity); more ranks sum in another
    order: the loss within 1e-5 relative, the per-scenario param rows within
    rtol 1e-3 / atol 1e-4 and their change by the step within 1e-3 of its
    max-abs, the gradient norms within 1e-5 relative, the imitation params
    within 1e-3 of their max-abs; the solve's controls within 1e-5 (each
    scenario's solve is the same thread's arithmetic). On every rank the
    sharded artifacts (shared params baked; per-scenario params an input)
    take the fused form and their ``objs`` and ``us`` equal the live solve
    of the shard bit for bit, their ``n_iters`` the max of the ranks' live
    counts."""
    world, r0 = len(ranks), ranks[0]
    exact = world == 1
    L = PROBE_LEN // world
    probe_want = np.concatenate([shard_probe_plain(torch.tensor(spec["probe"][r * L:(r + 1) * L])).numpy()
                                 for r in range(world)])
    ens, one = r0["ensemble"], single["ensemble"]
    rel = {k: abs(ens[k] - one[k]) / max(abs(one[k]), 1e-30)
           for k in ("loss", "grad_norm", "converged_frac", "qp_residual", "clamp_frac")}
    us_diff = np.abs(r0["solve"]["us"] - single["solve"]["us"]).max(axis=(0, 2))
    il_diff = max(float(np.abs(a["params"] - b["params"]).max()) / float(np.abs(b["params"]).max())
                  for a, b in zip(r0["imitation"]["steps"], single["imitation"]["steps"]))
    il_gn = max(abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
                for a, b in zip(r0["imitation"]["steps"], single["imitation"]["steps"]))
    # the step's change of the param rows, held to its own scale (about 1e-7
    # of the rows at 65,536 scenarios): a missing or doubled update shows
    moved = [p.astype(np.float64) - spec["params"] for p in (ens["params"], one["params"])]
    moved_diff = float(np.abs(moved[0] - moved[1]).max() / max(np.abs(moved[1]).max(), 1e-30))
    report = dict(
        world=world, backend=r0["backend"], device=r0["device"],
        probe_bit_equal=bool(np.array_equal(r0["probe"]["out"], probe_want)),
        ensemble_rel_diff=rel,
        ensemble_param_rows_bit_equal=int((ens["params"] == one["params"]).all(-1).sum()),
        ensemble_param_rows_max_abs_diff=float(np.abs(ens["params"] - one["params"]).max()),
        ensemble_param_change_rel_diff=moved_diff,
        solve_us_max_abs_diff=float(us_diff.max()),
        solve_scenarios_bit_equal=int((us_diff == 0).sum()), scenarios=len(us_diff),
        imitation_params_rel_diff=il_diff, imitation_grad_norm_rel_diff=il_gn,
        gather_in_rank_order=bool(np.array_equal(r0["gather"], spec["x"])),
        launches={part: [r[part]["launches"] for r in ranks]
                  for part in ("probe", "ensemble", "solve", "imitation", "artifact")},
        artifact=dict(form=[r["artifact"]["form"] for r in ranks], bytes=r0["artifact"]["bytes"],
                      export_s=[r["artifact"]["export_s"] for r in ranks],
                      objs_bit_equal=all(r["artifact"]["objs_bit_equal"] for r in ranks),
                      us_bit_equal=all(r["artifact"]["us_bit_equal"] for r in ranks),
                      n_iters=[r["artifact"]["n_iters"] for r in ranks],
                      params_form=[r["artifact"]["params_form"] for r in ranks],
                      params_objs_bit_equal=all(r["artifact"]["params_objs_bit_equal"] for r in ranks),
                      params_us_bit_equal=all(r["artifact"]["params_us_bit_equal"] for r in ranks),
                      params_n_iters=[r["artifact"]["params_n_iters"] for r in ranks]),
    )
    bad = [k for k in ("probe_bit_equal", "gather_in_rank_order") if not report[k]]
    art = report["artifact"]
    bad += ["artifact form"] * any(f != "fused" for f in art["form"])
    bad += ["artifact objs"] * (not art["objs_bit_equal"]) + ["artifact us"] * (not art["us_bit_equal"])
    bad += ["artifact n_iters"] * any(n != max(r["artifact"]["live_n_iters"] for r in ranks) for n in art["n_iters"])
    bad += ["per-scenario artifact form"] * any(f != "fused" for f in art["params_form"])
    bad += ["per-scenario artifact objs"] * (not art["params_objs_bit_equal"])
    bad += ["per-scenario artifact us"] * (not art["params_us_bit_equal"])
    bad += ["per-scenario artifact n_iters"] * any(n != max(r["artifact"]["params_live_n_iters"] for r in ranks)
                                                   for n in art["params_n_iters"])
    if exact:
        bad += [f"ensemble {k}" for k, v in rel.items() if v != 0]
        bad += ["ensemble param rows"] * (report["ensemble_param_rows_bit_equal"] != len(us_diff))
        bad += ["solve"] * (report["solve_scenarios_bit_equal"] != len(us_diff))
        bad += ["imitation"] * (il_diff != 0 or il_gn != 0)
    else:
        bad += [f"ensemble {k}" for k in ("loss", "grad_norm") if rel[k] > 1e-5]
        if not np.allclose(ens["params"], one["params"], rtol=1e-3, atol=1e-4):
            bad.append("ensemble param rows")
        bad += ["solve"] * (report["solve_us_max_abs_diff"] > 1e-5)
        bad += ["ensemble param change"] * (moved_diff > 1e-3)
        bad += ["imitation"] * (il_diff > 1e-3)
        bad += ["imitation grad_norm"] * (il_gn > 1e-5)
    if r0["device"].startswith("cuda"):
        per_rank = dict(probe=dict(probe=1), ensemble=dict(ilqr=1, kkt=1), solve=dict(ilqr=1, kkt=0),
                        imitation=dict(ilqr=spec["il_steps"], kkt=spec["il_steps"]), artifact=dict(ilqr=1, kkt=0))
        for part, want in per_rank.items():
            bad += [f"{part} launches on rank {r['rank']}: {r[part]['launches']}" for r in ranks
                    if any(r[part]["launches"][k] != v for k, v in want.items())]
        bad += [f"per-scenario artifact launches on rank {r['rank']}: {r['artifact']['params_launches']}"
                for r in ranks if r["artifact"]["params_launches"]["ilqr"] != 1]
    if bad:
        raise AssertionError(f"the {world}-rank dry run disagrees with one process: {bad}; {report}")
    return report


def _rank_main(rank, world, url, device, backend, fn, args, results) -> None:
    """A spawned rank: join the group, run ``fn(mesh, *args)``, send back its
    result. A failure is printed on stderr with the rank's traceback (the
    parent re-raises the first rank to exit, which may be a peer that lost
    its connection to the failing one)."""
    torch.set_num_threads(1)
    try:
        distributed.initialize(url, world, rank, device=device, backend=backend)
        results.put((rank, fn(make_mesh(), *args)))
    except BaseException:
        print(f"rank {rank} of {world} failed:\n{traceback.format_exc()}", file=sys.stderr, flush=True)
        raise
    finally:
        distributed.shutdown()


def spawn(world: int, fn, *args, device, backend=None) -> list:
    """Run ``fn(mesh, *args)`` on ``world`` ranks on ``device`` (``"cuda"``
    or ``"cpu"``; NCCL or gloo as :func:`~.distributed.initialize` chooses,
    unless ``backend`` is given), each a process of its own
    (``torch.multiprocessing``, ``spawn`` start method) with one intra-op
    thread, joined through a ``file://`` store; returns their results in rank
    order. ``fn`` must be a module-level function and its result picklable.
    A rank that fails makes this raise with its traceback; the others are
    stopped."""
    results = torch_mp.get_context("spawn").Queue()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        url = "file://" + os.path.join(tmp, "store")
        procs = torch_mp.start_processes(_rank_main, (world, url, str(device), backend, fn, args, results),
                                         nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            # read the results as they come (a rank exits only once its
            # result is sent); join(0) raises if a rank has failed
            while len(out) < world:
                try:
                    rank, value = results.get(timeout=1.0)
                    out[rank] = value
                except queue.Empty:
                    procs.join(timeout=0)
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"the ranks ran past {RANK_TIMEOUT_S} s")
            procs.join()
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
                p.join()
    return [out[r] for r in range(world)]


def run(world: int = 2, device=None, **spec_kw) -> dict:
    """The dry run: ``world`` spawned ranks (gloo on the CPU and when they
    share one card), the single process beside them, and :func:`check`'s
    report (which raises on disagreement) with each rank's launches and, on
    a card, times."""
    device = torch.device(device or "cuda")
    backend = "gloo" if device.type == "cpu" or world > torch.cuda.device_count() else "nccl"
    spec = make_spec(device, **spec_kw)
    ranks = spawn(world, rank_dryrun, spec, device=device, backend=backend)
    report = check(ranks, single_process(spec, device), spec)
    report["times"] = [dict(rank=r["rank"], ensemble_step_ms=r["ensemble"].get("step_ms"),
                            imitation_step_ms=r["imitation"].get("step_ms"),
                            all_reduce_ms=r["imitation"].get("all_reduce_ms")) for r in ranks]
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda (every rank on the card) or cpu")
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--il-batch", type=int, default=1024)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--lqr-iter", type=int, default=10)
    a = ap.parse_args(argv)
    if a.device.startswith("cuda") and not torch.cuda.is_available():
        print("dryrun: no CUDA device; pass --device cpu to run on the CPU", file=sys.stderr)
        return 1
    print(json.dumps(run(a.ranks, a.device, B=a.batch, T=a.horizon, lqr_iter=a.lqr_iter, il_batch=a.il_batch)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
