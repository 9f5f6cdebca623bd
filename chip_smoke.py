"""Drive the PyTorch port's main path once on an NVIDIA GPU, and check it.

Run from the repository root on a machine with a CUDA device:

    python3 chip_smoke.py

Phases, one line of output each (JSON where it carries numbers):

0. device: the card's name and power limit (nvidia-smi), or exit non-zero
   when there is no CUDA device; nothing runs on the CPU instead;
1. build: the CUDA kernels, built with nvcc from diffmpc_tpu_torch/csrc;
2. kernel vs plain: the fused iLQR kernel against its plain PyTorch version
   on the card, at the main-path problem (pendulum, T=20, B=1024, and the
   ragged B=1000; lqr_iter=10, eps=1e-5), one iteration at eps=0, and a
   warm start;
3. main path: the port's mpc_solve at the flagship configuration
   (pendulum, goal cost, box +-2, T=20, B=1024, lqr_iter=10), with the
   kernel's launch count, against the same solve on the CPU;
4. time: the solve at B=1024 and B=65,536, kernel and plain version, by
   CUDA events (best of several loops);
5. KKT kernel vs plain: the fused KKT backward against its plain PyTorch
   version on the card at T=20, B=1024 and the ragged B=1000, on the main
   path's own residuals (the solved trajectory, its linearization and the
   gradient of mean(us**2)) and on random residuals with ~20% tight
   controls; every output within 1e-4 * max(1, max|plain|);
6. gradient on the main path: torch.autograd.grad of mean(us**2) through
   mpc_solve with respect to the env's params, x_init and the cost's
   weights q, with one launch of each kernel, against the same on the CPU;
7. training: 40 imitation-learning steps of make_dp_train_step at B=1024;
   the loss must stay finite and end below where it started;
8. time: solve + gradient against the forward of the same loop, in strict
   alternation, at B=1024 and B=65,536, and the KKT kernel alone against
   its plain version.

The line before the last holds the kernels' record; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

T = 20
B_MAIN, B_RAGGED, B_ENSEMBLE = 1024, 1000, 65536
LQR_ITER, EPS = 10, 1e-5
TRUE_PARAMS, PARAMS0 = (10.0, 1.0, 1.0), (8.0, 1.25, 0.8)


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def x_init(B: int, seed: int = 0) -> np.ndarray:
    """The flagship initial states: random angle, speed in [-1, 1]."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, B)
    thdot = rng.uniform(-1.0, 1.0, B)
    return np.stack([np.cos(th), np.sin(th), thdot], -1).astype(np.float32)


def problem(B: int, device, seed: int = 0):
    """The flagship problem's kernel inputs on ``device``."""
    from diffmpc_tpu_torch.models import PendulumDx

    dx = PendulumDx.default(device=device)
    q, p = dx.get_true_obj()
    return dict(
        x_init=torch.tensor(x_init(B, seed), device=device),
        C=torch.diag(q).expand(T, B, 4, 4),
        c=p.expand(T, B, 4),
        dyn=dx,
        u_lower=torch.full((T, B, 1), -2.0, device=device),
        u_upper=torch.full((T, B, 1), 2.0, device=device),
    )


def compare(kernel, plain) -> dict:
    """Kernel vs plain by the chaos rule of the tests (tests/torch_parity.py):
    n_iters equal on most scenarios; on those, objectives within 1e-3
    relative and controls within 5e-3 where the last line-search step also
    agrees. A scenario converged to f32 noise on both sides may take another
    last step at the same objective (a tie); its controls stay within 5e-2."""
    k = {f: getattr(kernel, f).cpu().numpy() for f in kernel._fields}
    p = {f: getattr(plain, f).cpu().numpy() for f in plain._fields}
    same = k["n_iters"] == p["n_iters"]
    tie = same & (k["alpha"] != p["alpha"])
    keep = same & ~tie
    us_diff = np.abs(k["us"] - p["us"]).max(axis=(0, 2))
    rel = np.abs(k["objs"] - p["objs"]) / np.maximum(np.abs(p["objs"]), 1e-6)
    return dict(
        n_iters_equal_frac=float(same.mean()),
        objs_max_rel=float(rel[same].max()),
        us_max_abs=float(us_diff[keep].max()),
        us_max_abs_incl_ties=float(us_diff[same].max()),
        ties=int(tie.sum()),
        ties_converged=bool((k["converged"][tie] & p["converged"][tie]).all()),
        ties_us_max_abs=float(us_diff[tie].max()) if tie.any() else 0.0,
        converged_frac_kernel=float(k["converged"].mean()),
        converged_frac_plain=float(p["converged"].mean()),
    )


def check_chaos(name: str, m: dict, min_equal: float = 0.95) -> None:
    ok = (
        m["n_iters_equal_frac"] >= min_equal
        and m["objs_max_rel"] <= 1e-3
        and m["us_max_abs"] <= 5e-3
        and m["ties_converged"]
        and m["ties_us_max_abs"] <= 5e-2
    )
    if not ok:
        raise AssertionError(f"{name}: kernel and plain version disagree: {m}")


def check_tight(name: str, kernel, plain, tol: float = 1e-4) -> float:
    worst = 0.0
    for f in kernel._fields:
        a = getattr(kernel, f).double().cpu().nan_to_num(posinf=0.0)
        b = getattr(plain, f).double().cpu().nan_to_num(posinf=0.0)
        worst = max(worst, float((a - b).abs().max()))
    if worst > tol or not torch.equal(kernel.n_iters.cpu(), plain.n_iters.cpu()):
        raise AssertionError(f"{name}: max abs difference {worst} > {tol} or n_iters differ")
    return worst


def cuda_ms(fn, loops: int, reps: int) -> float:
    """Best over ``reps`` of the mean time of ``loops`` calls, by CUDA events."""
    fn()  # warm up
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(loops):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / loops)
    return best


def random_kkt_inputs(B: int, device, seed: int = 0, tight_share: float = 0.2):
    """Random KKT-backward residuals at T=20, n=3, m=1 (the recipe of
    tests/test_pallas_kkt.py): an SPD cost, random dynamics, controls in
    [-1, 1] with ``tight_share`` of them parked on the bound."""
    n, m = 3, 1
    nm = n + m
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(T, B, nm, nm)) * 0.3
    C = A @ np.swapaxes(A, -1, -2) + np.eye(nm)
    u = rng.uniform(-0.9, 0.9, size=(T, B, m))
    u.reshape(-1)[rng.choice(T * B * m, int(tight_share * T * B * m), replace=False)] = 1.0
    tau = np.concatenate([rng.normal(size=(T, B, n)), u], -1)
    tight = u >= 1.0 - 1e-6
    r = rng.normal(size=(T, B, nm))
    r[..., n:][tight] = 0.0
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return (f32(C), f32(rng.normal(size=(T, B, nm))), f32(rng.normal(size=(T, B, n, nm)) * 0.4),
            f32(r), f32(tau), torch.tensor(tight, device=device))


def main_path_kkt_inputs(B: int, device):
    """The KKT backward's inputs on the main path: the flagship solve's
    trajectory, the env linearized at it, and the gradient of mean(us**2)
    with tight controls zeroed, as lqr_fixed_point builds them."""
    from diffmpc_tpu_torch.ops.cuda.ilqr import ilqr_solve_fused
    from diffmpc_tpu_torch.ops.linearize import linearize_dynamics

    prob = problem(B, device)
    sol = ilqr_solve_fused(**prob, lqr_iter=LQR_ITER, eps=EPS)
    F, _ = linearize_dynamics(prob["dyn"], sol.xs, sol.us)
    us = sol.us.clone().requires_grad_(True)
    gx = torch.zeros_like(sol.xs)  # the loss does not read the states
    (gu,) = torch.autograd.grad((us**2).mean(), us)
    tight = (sol.us <= prob["u_lower"] + 1e-6) | (sol.us >= prob["u_upper"] - 1e-6)
    gu = torch.where(tight, 0.0, gu)
    return (prob["C"], prob["c"], F, torch.cat([gx, gu], -1),
            torch.cat([sol.xs, sol.us], -1), tight)


def check_kkt(name: str, kernel, plain) -> float:
    """Every output within 1e-4 * max(1, max|plain|): one linear pass, no
    chaos. Returns the largest absolute difference."""
    worst = 0.0
    for out, k, p in zip(("dx_init", "dC", "dc", "dF", "df"), kernel, plain):
        err = float((k - p).abs().max())
        bound = 1e-4 * max(1.0, float(p.abs().max()))
        if not err <= bound:
            raise AssertionError(f"{name}: KKT kernel vs plain, {out}: {err} > {bound}")
        worst = max(worst, err)
    return worst


def flagship_grads(config, B: int, device, params=None):
    """Gradients of mean(us**2) through mpc_solve on the flagship problem
    with respect to the env's params, x_init and the cost's weights q."""
    from diffmpc_tpu_torch import QuadCost, mpc_solve
    from diffmpc_tpu_torch.models import PendulumDx

    dx = PendulumDx.default(device=device)
    q, p = dx.get_true_obj()
    prm = (dx.params if params is None else params).clone().requires_grad_(True)
    x = torch.tensor(x_init(B), device=device).requires_grad_(True)
    q = q.clone().requires_grad_(True)
    sol = mpc_solve(config, x, QuadCost(torch.diag(q), p), dx.replace(params=prm),
                    u_lower=-2.0, u_upper=2.0)
    g_prm, g_x, g_q = torch.autograd.grad((sol.us**2).mean(), (prm, x, q))
    return sol, dict(params=g_prm, x_init=g_x, q=g_q)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA device", file=sys.stderr)
        return 1
    from diffmpc_tpu_torch import MPCConfig, QuadCost, mpc_solve
    from diffmpc_tpu_torch.csrc import build
    from diffmpc_tpu_torch.ops.cuda.ilqr import ilqr_solve_fused, ilqr_solve_plain
    from diffmpc_tpu_torch.ops.cuda.kkt import kkt_backward_fused, kkt_backward_plain
    from diffmpc_tpu_torch.parallel import generate_expert_data, init_train_state, make_dp_train_step

    # ---- 0. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(phase="device", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 1. build ----
    t0 = time.perf_counter()
    so, log = build.build()
    build.load()
    emit(
        phase="build", seconds=time.perf_counter() - t0,
        library=os.path.relpath(so), fresh=bool(log),
        ptxas=[ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln],
    )

    # ---- 2. kernel vs plain on the card ----
    knobs = dict(lqr_iter=LQR_ITER, eps=EPS)
    results = {}
    for B in (B_MAIN, B_RAGGED):
        prob = problem(B, device)
        kernel = ilqr_solve_fused(**prob, **knobs)
        plain = ilqr_solve_plain(**prob, **knobs)
        m = compare(kernel, plain)
        emit(phase="kernel_vs_plain", B=B, T=T, **knobs, **m)
        check_chaos(f"B={B}", m)
        results[B] = (kernel, m)
    prob = problem(B_MAIN, device)
    one = dict(lqr_iter=1, eps=0.0)
    err1 = check_tight("lqr_iter=1", ilqr_solve_fused(**prob, **one), ilqr_solve_plain(**prob, **one))
    emit(phase="kernel_vs_plain", B=B_MAIN, T=T, **one, max_abs_err=err1, tol=1e-4)
    u_warm = torch.roll(results[B_MAIN][0].us, -1, dims=0).contiguous()
    mw = compare(
        ilqr_solve_fused(**prob, u_init=u_warm, **knobs),
        ilqr_solve_plain(**prob, u_init=u_warm, **knobs),
    )
    emit(phase="kernel_vs_plain", B=B_MAIN, T=T, warm_start=True, **knobs, **mw)
    check_chaos("warm start", mw)

    # ---- 3. the main path: mpc_solve at the flagship configuration ----
    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=LQR_ITER, eps=EPS,
        exit_unconverged=False, detach_unconverged=False,
    )
    dx = prob["dyn"]
    q, p = dx.get_true_obj()
    cost = QuadCost(torch.diag(q), p)
    x = prob["x_init"]
    ilqr_solve_fused.launches = kkt_backward_fused.launches = 0
    sol = mpc_solve(config, x, cost, dx, u_lower=-2.0, u_upper=2.0)
    torch.cuda.synchronize()
    launches = ilqr_solve_fused.launches
    if launches < 1:
        raise AssertionError("mpc_solve did not launch the iLQR kernel")
    if kkt_backward_fused.launches != 0 or sol.us.requires_grad:
        raise AssertionError("a forward-only solve attached a gradient")
    if sol.us.shape != (T, B_MAIN, 1) or sol.xs.shape != (T, B_MAIN, 3):
        raise AssertionError(f"shapes {tuple(sol.xs.shape)}, {tuple(sol.us.shape)}")
    if not bool(torch.isfinite(sol.objs).all()) or not bool(torch.isfinite(sol.xs).all()):
        raise AssertionError("non-finite solution")
    if float(sol.us.abs().max()) > 2.0:
        raise AssertionError("controls outside the box [-2, 2]")
    cpu = mpc_solve(
        config, x.cpu(), QuadCost(cost.C.cpu(), cost.c.cpu()),
        dx.replace(params=dx.params.cpu()), u_lower=-2.0, u_upper=2.0,
    )
    conv_gpu = float(sol.info.converged.float().mean())
    conv_cpu = float(cpu.info.converged.float().mean())
    mean_gpu, mean_cpu = float(sol.objs.mean()), float(cpu.objs.mean())
    emit(
        phase="main_path", B=B_MAIN, T=T, lqr_iter=LQR_ITER, launches=launches,
        converged_frac=conv_gpu, mean_obj=mean_gpu, max_n_iters=int(sol.info.n_iters),
        cpu_converged_frac=conv_cpu, cpu_mean_obj=mean_cpu,
    )
    if abs(conv_gpu - conv_cpu) > 0.05 or abs(mean_gpu - mean_cpu) > 1e-2 * abs(mean_cpu):
        raise AssertionError("mpc_solve on the card disagrees with the same solve on the CPU")

    # ---- 4. time ----
    times = {}
    for B, k_loops, p_reps in ((B_MAIN, 20, 3), (B_ENSEMBLE, 5, 2)):
        prob = problem(B, device)
        kernel_ms = cuda_ms(lambda: ilqr_solve_fused(**prob, **knobs), k_loops, 3)
        plain_ms = cuda_ms(lambda: ilqr_solve_plain(**prob, **knobs), 1, p_reps)
        solve_ms = cuda_ms(
            lambda: mpc_solve(config, prob["x_init"], cost, dx, u_lower=-2.0, u_upper=2.0),
            k_loops, 3,
        )
        times[B] = (kernel_ms, plain_ms)
        emit(
            phase="time", B=B, T=T, lqr_iter=LQR_ITER, card=smi,
            kernel_ms=kernel_ms, kernel_solves_per_s=B / kernel_ms * 1e3,
            plain_ms=plain_ms, plain_solves_per_s=B / plain_ms * 1e3,
            mpc_solve_ms=solve_ms, mpc_solve_solves_per_s=B / solve_ms * 1e3,
        )

    # ---- 5. KKT kernel vs plain on the card ----
    kkt_err = 0.0
    for B in (B_MAIN, B_RAGGED):
        for residuals, ins in (("main_path", main_path_kkt_inputs(B, device)),
                               ("random", random_kkt_inputs(B, device, seed=B))):
            err = check_kkt(f"{residuals} B={B}", kkt_backward_fused(*ins), kkt_backward_plain(*ins))
            torch.cuda.synchronize()
            emit(phase="kkt_vs_plain", B=B, T=T, residuals=residuals,
                 tight_share=float(ins[-1].float().mean()), max_abs_err=err,
                 tol="1e-4 * max(1, max|plain|)")
            kkt_err = max(kkt_err, err)

    # ---- 6. gradient on the main path, against the same on the CPU ----
    grad_config = dataclasses.replace(config, detach_unconverged=False)
    ilqr_solve_fused.launches = kkt_backward_fused.launches = 0
    gsol, g = flagship_grads(grad_config, B_MAIN, device)
    torch.cuda.synchronize()
    counts = (ilqr_solve_fused.launches, kkt_backward_fused.launches)
    if counts != (1, 1):
        raise AssertionError(f"solve + gradient launched (iLQR, KKT) = {counts}, not (1, 1)")
    if not all(bool(torch.isfinite(v).all()) for v in g.values()):
        raise AssertionError("non-finite gradient on the main path")
    one = dataclasses.replace(grad_config, lqr_iter=1, eps=0.0)
    _, g1 = flagship_grads(one, B_MAIN, device)
    _, c1 = flagship_grads(one, B_MAIN, "cpu")
    rel = {k: float((g1[k].cpu() - c1[k]).abs().max() / c1[k].abs().max()) for k in g1}
    if max(rel["params"], rel["q"], rel["x_init"]) > 1e-3:
        raise AssertionError(f"one-iteration gradients, card vs CPU: {rel}")
    csol, c = flagship_grads(grad_config, B_MAIN, "cpu")
    agree = (gsol.us.detach().cpu() - csol.us.detach()).abs().amax(dim=(0, 2)) <= 1e-4
    gx, cx = g["x_init"].cpu()[agree], c["x_init"][agree]
    rel10 = float((gx - cx).abs().max() / c["x_init"].abs().max())
    emit(phase="gradient", B=B_MAIN, T=T, lqr_iter=LQR_ITER, launches=dict(ilqr=counts[0], kkt=counts[1]),
         one_iteration_rel_err=rel, agree_frac=float(agree.float().mean()),
         x_init_rows_rel_err=rel10, params_grad=g["params"].tolist(),
         cpu_params_grad=c["params"].tolist())
    if rel10 > 1e-3 or float(agree.float().mean()) < 0.9:
        raise AssertionError(f"ten-iteration x_init gradient rows, card vs CPU: {rel10}")

    # ---- 7. training: 40 imitation-learning steps ----
    train_config = dataclasses.replace(config, detach_unconverged=True)
    true_dx = dx.replace(params=torch.tensor(TRUE_PARAMS, device=device))
    _, u_expert, _ = generate_expert_data(train_config, cost, true_dx, x, -2.0, 2.0)
    adam = functools.partial(torch.optim.Adam, lr=5e-2)
    step = make_dp_train_step(
        train_config, lambda prm: (cost, true_dx.replace(params=prm)), adam, None, -2.0, 2.0
    )
    state = init_train_state(torch.tensor(PARAMS0, device=device), adam)
    losses = []
    ilqr_solve_fused.launches = kkt_backward_fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(40):
        state, stats = step(state, x, u_expert)
        losses.append(float(stats.loss))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 40 * 1e3
    train_launches = (ilqr_solve_fused.launches, kkt_backward_fused.launches)
    emit(phase="train", B=B_MAIN, T=T, lqr_iter=LQR_ITER, steps=40,
         losses={i: losses[i] for i in (0, 10, 20, 39)},
         params=state.params.tolist(), converged_frac=float(stats.converged_frac),
         grad_norm=float(stats.grad_norm), ms_per_step=step_ms,
         launches=dict(ilqr=train_launches[0], kkt=train_launches[1]))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training did not lower a finite loss: {losses[::10]}")
    if train_launches != (40, 40):
        raise AssertionError(f"40 steps launched (iLQR, KKT) = {train_launches}")

    # ---- 8. time: solve + gradient vs forward, and the KKT kernel ----
    kkt_times = {}
    for B, loops in ((B_MAIN, 20), (B_ENSEMBLE, 5)):
        xb = torch.tensor(x_init(B, seed=21), device=device)
        prm = dx.params.clone().requires_grad_(True)
        dxg = dx.replace(params=prm)

        def fwd():
            with torch.no_grad():
                mpc_solve(config, xb, cost, dxg, u_lower=-2.0, u_upper=2.0).us.pow(2).mean()

        def fwd_grad():
            us = mpc_solve(grad_config, xb, cost, dxg, u_lower=-2.0, u_upper=2.0).us
            torch.autograd.grad(us.pow(2).mean(), prm)

        # strict alternation, best of each: two loops timed minutes apart
        # see different clocks and neighbours
        t_f = t_g = float("inf")
        for _ in range(5):
            t_f = min(t_f, cuda_ms(fwd, loops, 1))
            t_g = min(t_g, cuda_ms(fwd_grad, loops, 1))
        ins = main_path_kkt_inputs(B, device)
        k_ms = cuda_ms(lambda: kkt_backward_fused(*ins), loops * 5, 3)
        p_ms = cuda_ms(lambda: kkt_backward_plain(*ins), 1, 1)
        kkt_times[B] = (k_ms, p_ms)
        emit(phase="time_grad", B=B, T=T, lqr_iter=LQR_ITER, card=smi,
             solve_plus_grad_ms=t_g, solve_plus_grad_per_s=B / t_g * 1e3,
             fwd_ms=t_f, fwd_per_s=B / t_f * 1e3, grad_vs_fwd_frac=t_f / t_g,
             kkt_kernel_ms=k_ms, kkt_plain_ms=p_ms)

    print(smi, flush=True)
    emit(kernels=[
        dict(
            name="ilqr_solve_fused",
            route="cuda",
            source="diffmpc_tpu_torch/csrc/ilqr.cu",
            replaces="diffmpc_tpu/ops/pallas/ilqr.py:458",
            launches=launches,
            max_abs_err=results[B_MAIN][1]["us_max_abs"],
            ms=times[B_MAIN][0],
            plain_ms=times[B_MAIN][1],
        ),
        dict(
            name="kkt_backward_fused",
            route="cuda",
            source="diffmpc_tpu_torch/csrc/kkt.cu",
            replaces="diffmpc_tpu/ops/pallas/kkt.py:245",
            launches=train_launches[1],
            max_abs_err=kkt_err,
            ms=kkt_times[B_MAIN][0],
            plain_ms=kkt_times[B_MAIN][1],
        ),
    ])
    emit(ok=True, device=dict(platform="gpu", kind=kind, count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
