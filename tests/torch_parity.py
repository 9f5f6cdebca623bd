"""Shared inputs and comparison rules of the PyTorch port's tests.

Imports torch and numpy only (no JAX), so the tests that run on the card,
where JAX is not installed, use it too.
"""

import numpy as np
import torch

from diffmpc_tpu_torch.models import PendulumDx
from diffmpc_tpu_torch.ops.cuda.ilqr import ilqr_solve_plain

B, T = 48, 8


def make_problem(seed=700, batched_params=False, warm=False, B=B, T=T):
    """The fused-kernel test problem of tests/test_pallas_ilqr.py as numpy
    float32 arrays: swing-up pendulum, goal cost, box +-2."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, B)
    x = np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, B)], -1)
    q = np.array([1.0, 1.0, 0.1, 0.001])
    p = np.array([-1.0, 0.0, 0.0, 0.0])
    prob = dict(
        x_init=x,
        C=np.broadcast_to(np.diag(q), (T, B, 4, 4)),
        c=np.broadcast_to(p, (T, B, 4)),
        u_lower=np.full((T, B, 1), -2.0),
        u_upper=np.full((T, B, 1), 2.0),
        params=np.array([10.0, 1.0, 1.0]),
        u_init=None,
    )
    if batched_params:
        prob["params"] = prob["params"] * rng.uniform(0.9, 1.1, (B, 3))
    if warm:
        prob["u_init"] = rng.uniform(-2.5, 2.5, (T, B, 1))
    return {k: None if v is None else np.ascontiguousarray(v, np.float32) for k, v in prob.items()}


def random_residuals(rng, T, B, n, m, n_tight=0):
    """tests/test_pallas_kkt.py's ``_random_residuals``, as numpy float32:
    an SPD cost, random dynamics, a trajectory inside the box [-1, 1] with
    ``n_tight`` controls parked exactly on the upper bound, and a random
    incoming gradient."""
    nm = n + m
    A = rng.normal(size=(T, B, nm, nm)) * 0.3
    C = A @ np.swapaxes(A, -1, -2) + np.eye(nm)
    c = rng.normal(size=(T, B, nm))
    F = rng.normal(size=(T, B, n, nm)) * 0.4
    x_star = rng.normal(size=(T, B, n))
    u_star = rng.uniform(-0.9, 0.9, size=(T, B, m))
    if n_tight:
        flat = rng.choice(T * B * m, size=n_tight, replace=False)
        u_star.reshape(-1)[flat] = 1.0
    gx = rng.normal(size=(T, B, n))
    gu = rng.normal(size=(T, B, m))
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return dict(
        C=f32(C), c=f32(c), F=f32(F), x_star=f32(x_star), u_star=f32(u_star),
        lo=f32(np.full((T, B, m), -1.0)), hi=f32(np.full((T, B, m), 1.0)),
        gx=f32(gx), gu=f32(gu),
    )


def kernel_inputs(res, eps=1e-6):
    """The fused backward's inputs ``(C, c, F, r, tau, tight)`` as numpy,
    built as ``_kkt_backward_impl`` builds them."""
    tight = (res["u_star"] <= res["lo"] + eps) | (res["u_star"] >= res["hi"] - eps)
    r = np.concatenate([res["gx"], np.where(tight, 0.0, res["gu"])], -1).astype(np.float32)
    tau = np.concatenate([res["x_star"], res["u_star"]], -1)
    return res["C"], res["c"], res["F"], r, tau, tight


def torch_inputs(prob, device=None):
    t = {k: None if v is None else torch.tensor(v, device=device) for k, v in prob.items()}
    dx = PendulumDx(params=t.pop("params"))
    return t, dx


def solve_plain(prob, **knobs):
    t, dx = torch_inputs(prob)
    out = ilqr_solve_plain(
        t["x_init"], t["C"], t["c"], dx, t["u_lower"], t["u_upper"],
        u_init=t["u_init"], **knobs,
    )
    return as_numpy(out)


def as_numpy(result):
    """A FusedSolveResult as a dict of numpy arrays."""
    return {f: getattr(result, f).cpu().numpy() for f in result._fields}


def assert_tight(got, want, tol=1e-4):
    for f, w in want.items():
        g = got[f]
        if f == "last_improvement":  # +inf where nothing ran
            g, w = np.where(np.isinf(g), 0, g), np.where(np.isinf(w), 0, w)
        np.testing.assert_allclose(
            g.astype(np.float64), w.astype(np.float64), atol=tol, rtol=0, err_msg=f
        )
    np.testing.assert_array_equal(got["n_iters"], want["n_iters"])


def assert_chaos(got, want):
    """The chaos rule. ``n_iters`` equal on >= 90% of scenarios, objectives
    within 1e-3 on those, controls within 5e-3 on those whose last
    line-search step (``alpha``) agrees too. Once a scenario has converged
    to f32 noise, the accept test ``obj_a < cur_obj`` is decided by an ulp,
    so the two sides may take different last steps at the same objective,
    along directions the cost hardly sees. Such a tie must have converged
    on both sides, and its controls stay within 5e-2."""
    same = got["n_iters"] == want["n_iters"]
    assert same.mean() >= 0.9, same.mean()
    np.testing.assert_allclose(got["objs"][same], want["objs"][same], rtol=1e-3, atol=1e-3)
    tie = same & (got["alpha"] != want["alpha"])
    assert (got["converged"][tie] & want["converged"][tie]).all()
    np.testing.assert_allclose(got["us"][:, tie], want["us"][:, tie], atol=5e-2)
    keep = same & ~tie
    np.testing.assert_allclose(got["us"][:, keep], want["us"][:, keep], atol=5e-3)
