"""The non-fused path as a whole: the port's ``mpc_solve`` on ``LinDx``
problems, with and without a box, and on the pendulum when the JAX dispatch
sends it there (``verbose > 0``, ``GradMethods.FINITE_DIFF``), against the
JAX package's solve and its goldens, on the CPU (the kernels' plain
versions; the JAX side on its XLA path).

Tolerances:

- the goldens at atol 1e-4, with the exact recipes of
  tests/test_parity_golden.py;
- box-DDP n=4, m=2, T=20, B=16 (BASELINE.json config 2 at B=16): controls
  within 1e-4 and ``converged`` equal (unconstrained config 1: equal on 90%,
  see the test). ``n_iters`` (the iterations until
  every scenario froze) within 2: a scenario converged to float32 noise
  freezes when one ladder step improves its objective by less than ``eps``,
  an ulp-level decision that the two packages' summation orders take
  differently in one late iteration;
- gradients of a fixed loss in ``xs, us`` with respect to
  ``x_init, C, c, F, f`` within ``1e-4 * max|JAX|``;
- ``kkt_backward_composite`` against ``kkt_backward_plain`` within 1e-5;
- the pendulum within 1e-4 after one iteration, and by the chaos rule of
  tests/torch_parity.py after ten. With ``FINITE_DIFF`` the inputs are
  float64: central differences with step 1e-4 in float32 carry about 1e-3
  of rounding noise (an ulp of the step's output over 2e-4), which the two
  packages' ``sin``/``cos``/``atan2`` realize differently; in float64 that
  noise is about 1e-12, and the port's plain versions compute in float64
  too.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import diffmpc_tpu as jdm  # noqa: E402
import diffmpc_tpu_torch as tdm  # noqa: E402
from diffmpc_tpu.models import PendulumDx as JaxPendulumDx  # noqa: E402
from diffmpc_tpu.ops.linearize import linearize_dynamics as jax_linearize  # noqa: E402
from diffmpc_tpu.ops.lqr_step import LqrSpec as JaxLqrSpec  # noqa: E402
from diffmpc_tpu.ops.lqr_step import lqr_step as jax_lqr_step  # noqa: E402
from diffmpc_tpu_torch import convert  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.kkt import kkt_backward_plain  # noqa: E402
from diffmpc_tpu_torch.ops.linearize import linearize_dynamics  # noqa: E402
from diffmpc_tpu_torch.ops.lqr_step import LqrSpec, kkt_backward_composite, lqr_step  # noqa: E402
from oracles import random_lqr_problem  # noqa: E402
from torch_parity import assert_chaos, kernel_inputs, random_residuals  # noqa: E402

BOX = 0.6
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def golden(name):
    return dict(np.load(os.path.join(GOLDEN_DIR, name + ".npz")))


def problem(seed, T, B, n, m):
    rng = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in random_lqr_problem(rng, T, B, n, m)]


def torch_problem(C, c, F, f, x0):
    return torch.tensor(x0), tdm.QuadCost(torch.tensor(C), torch.tensor(c)), tdm.LinDx(torch.tensor(F), torch.tensor(f))


@functools.partial(jax.jit, static_argnames=("config", "box"))
def jax_solve(config, x0, C, c, F, f, *, box):
    bounds = dict(u_lower=-box, u_upper=box) if box else {}
    return jdm.mpc_solve(config, x0, jdm.QuadCost(C, c), jdm.LinDx(F, f), **bounds)


# ---------------------------------------------------------------------------
# The goldens (tests/test_parity_golden.py's recipes).
# ---------------------------------------------------------------------------


def test_unconstrained_lqr_matches_the_golden():
    rng = np.random.default_rng(1234)
    T, B, n, m = 10, 32, 3, 2
    C, c, F, f, x_init = random_lqr_problem(rng, T, B, n, m)
    g = golden("lqr_unconstrained_n3m2T10B32")
    ctrl = tdm.MPC(n, m, T, lqr_iter=4, exit_unconverged=False)
    as32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    _, us, _ = ctrl(as32(x_init), tdm.QuadCost(as32(C), as32(c)), tdm.LinDx(as32(F), as32(f)))
    np.testing.assert_allclose(us.numpy(), g["us"], atol=1e-4)


def test_box_ddp_matches_the_golden():
    rng = np.random.default_rng(4321)
    T, B, n, m = 20, 16, 4, 1
    C, c, F, f, x_init = random_lqr_problem(rng, T, B, n, m)
    g = golden("boxddp_n4m1T20B16")
    ctrl = tdm.MPC(
        n, m, T, u_lower=-BOX, u_upper=BOX, lqr_iter=60, exit_unconverged=False,
        eps=1e-12, not_improved_lim=10**6,
    )
    as32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    _, us, _ = ctrl(as32(x_init), tdm.QuadCost(as32(C), as32(c)), tdm.LinDx(as32(F), as32(f)))
    np.testing.assert_allclose(us.numpy(), g["us"], atol=1e-4)


# ---------------------------------------------------------------------------
# Against the JAX package's solve.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "shape,box,lqr_iter",
    [((20, 16, 4, 2), BOX, 10), ((10, 32, 3, 2), None, 4)],
    ids=["boxddp_n4m2", "unconstrained_n3m2"],
)
def test_mpc_solve_matches_jax(shape, box, lqr_iter):
    T, B, n, m = shape
    arrays = problem(11, T, B, n, m)
    jconfig = jdm.MPCConfig(n_state=n, n_ctrl=m, T=T, lqr_iter=lqr_iter, exit_unconverged=False)
    want = jax_solve(jconfig, *map(jnp.asarray, (arrays[4],) + tuple(arrays[:4])), box=box)
    x0, cost, dx = torch_problem(*arrays)
    bounds = dict(u_lower=-box, u_upper=box) if box else {}
    got = tdm.mpc_solve(convert.mpc_config_from_jax(jconfig), x0, cost, dx, **bounds)
    np.testing.assert_allclose(got.us.numpy(), np.asarray(want.us), atol=1e-4)
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(want.xs), atol=1e-4)
    np.testing.assert_allclose(got.objs.numpy(), np.asarray(want.objs), rtol=1e-5)
    assert abs(int(got.info.n_iters) - int(want.info.n_iters)) <= 2
    assert got.info.n_iters.dtype == torch.int32
    np.testing.assert_allclose(got.info.qp_iters.numpy(), np.asarray(want.info.qp_iters))
    np.testing.assert_allclose(got.info.clamp_frac.numpy(), np.asarray(want.info.clamp_frac), atol=1e-6)
    if box:
        np.testing.assert_array_equal(got.info.converged.numpy(), np.asarray(want.info.converged))
        assert float(got.us.abs().max()) <= np.float32(box) and float(got.info.clamp_frac.mean()) > 0.05
    else:
        # one iteration solves an LQR exactly; the next ones improve it by
        # +-1 ulp of the objective, so "improvement < eps" is rounding noise
        same = got.info.converged.numpy() == np.asarray(want.info.converged)
        assert same.mean() >= 0.9


@functools.partial(jax.jit, static_argnames=("config", "box"))
def jax_grads(config, x0, C, c, F, f, wx, wu, *, box):
    def loss(*leaves):
        sol = jax_solve(config, *leaves, box=box)
        return jnp.sum(sol.xs * wx) + jnp.sum(sol.us * wu)

    return jax.grad(loss, argnums=range(5))(x0, C, c, F, f)


@pytest.mark.parametrize("box", [BOX, None], ids=["boxed", "unconstrained"])
def test_gradients_match_jax(box):
    T, B, n, m = 10, 8, 4, 2
    C, c, F, f, x0 = problem(21, T, B, n, m)
    rng = np.random.default_rng(22)
    wx = rng.normal(size=(T, B, n)).astype(np.float32)
    wu = rng.normal(size=(T, B, m)).astype(np.float32)
    jconfig = jdm.MPCConfig(n_state=n, n_ctrl=m, T=T, lqr_iter=10, exit_unconverged=False)
    want = jax_grads(jconfig, *map(jnp.asarray, (x0, C, c, F, f, wx, wu)), box=box)
    leaves = [torch.tensor(a, requires_grad=True) for a in (x0, C, c, F, f)]
    bounds = dict(u_lower=-box, u_upper=box) if box else {}
    sol = tdm.mpc_solve(
        convert.mpc_config_from_jax(jconfig), leaves[0], tdm.QuadCost(leaves[1], leaves[2]),
        tdm.LinDx(leaves[3], leaves[4]), **bounds,
    )
    assert bool(sol.info.converged.all())
    loss = (sol.xs * torch.tensor(wx)).sum() + (sol.us * torch.tensor(wu)).sum()
    got = torch.autograd.grad(loss, leaves)
    for name, g, w in zip(("x_init", "C", "c", "F", "f"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and bool(g.abs().max() > 0), name
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=0, err_msg=name)


@pytest.mark.parametrize("n,m", [(3, 2), (4, 2)])
def test_composite_backward_matches_the_kkt_plain_version(n, m):
    res = random_residuals(np.random.default_rng(50 + n), 9, 24, n, m, 60)
    ins = [torch.tensor(a) for a in kernel_inputs(res)]
    got = kkt_backward_composite(*ins, reg=1e-7)
    want = kkt_backward_plain(*ins, reg=1e-7)
    for name, g, w in zip(("dx_init", "dC", "dc", "dF", "df"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=1e-5, err_msg=name)


def test_lqr_step_matches_jax():
    T, B, n, m = 8, 24, 4, 2
    C, c, F, f, x0 = problem(31, T, B, n, m)
    rng = np.random.default_rng(32)
    x_hat = rng.normal(size=(T, B, n)).astype(np.float32)
    u_hat = rng.uniform(-0.5, 0.5, (T, B, m)).astype(np.float32)
    lo, hi = np.full((T, B, m), -BOX, np.float32), np.full((T, B, m), BOX, np.float32)
    arrays = (x0, C, c, F, f, x_hat, u_hat, lo, hi)
    want = jax.jit(jax_lqr_step, static_argnums=0)(JaxLqrSpec(n_state=n, constrained=True), *map(jnp.asarray, arrays))
    got = lqr_step(LqrSpec(n_state=n, constrained=True), *map(torch.tensor, arrays))
    for name in ("xs", "us", "objs", "alpha"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), atol=1e-4, rtol=1e-5, err_msg=name)
    for name in ("improved", "free_mask", "n_qp_iter"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)


# ---------------------------------------------------------------------------
# The pendulum on the non-fused path.
# ---------------------------------------------------------------------------

PT, PB = 8, 48


def pendulum_x_init():
    rng = np.random.default_rng(0)
    th = rng.uniform(-np.pi, np.pi, PB)
    return np.stack([np.cos(th), np.sin(th), rng.uniform(-1.0, 1.0, PB)], -1).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("config",))
def jax_pendulum(config, x0):
    dx = JaxPendulumDx.default(x0.dtype)
    q, p = dx.get_true_obj()
    return jdm.mpc_solve(config, x0, jdm.QuadCost(jnp.diag(q), p), dx, u_lower=-2.0, u_upper=2.0)


@pytest.mark.parametrize("lqr_iter", [1, 10])
@pytest.mark.parametrize("knob", ["verbose", "finite_diff"])
def test_pendulum_off_the_fused_path_matches_jax(knob, lqr_iter, capsys):
    kw = dict(verbose=1) if knob == "verbose" else dict(grad_method=jdm.GradMethods.FINITE_DIFF)
    jconfig = jdm.MPCConfig(
        n_state=3, n_ctrl=1, T=PT, lqr_iter=lqr_iter, eps=0.0 if lqr_iter == 1 else 1e-5,
        exit_unconverged=False, detach_unconverged=False, **kw,
    )
    x0 = pendulum_x_init().astype(np.float64 if knob == "finite_diff" else np.float32)
    want = jax_pendulum(jconfig, jnp.asarray(x0))
    jax.effects_barrier()
    capsys.readouterr()
    dx = convert.pendulum_from_jax(JaxPendulumDx.default(x0.dtype), device="cpu")
    q, p = dx.get_true_obj()
    got = tdm.mpc_solve(
        convert.mpc_config_from_jax(jconfig), torch.tensor(x0),
        tdm.QuadCost(torch.diag(q), p), dx, u_lower=-2.0, u_upper=2.0,
    )
    lines = capsys.readouterr().out.splitlines()
    if knob == "verbose":
        assert len(lines) == int(got.info.n_iters) and lines[0].startswith("ilqr iter 0: mean obj ")
    else:
        assert not lines
    as_np = lambda s: dict(  # noqa: E731
        us=np.asarray(s.us), objs=np.asarray(s.objs), converged=np.asarray(s.info.converged),
        alpha=np.asarray(s.info.mean_alpha), n_iters=np.asarray(s.info.converged).astype(np.int32),
    )
    if lqr_iter == 1:
        for name in ("us", "xs", "objs"):
            np.testing.assert_allclose(
                getattr(got, name).numpy(), np.asarray(getattr(want, name)), atol=1e-4, rtol=1e-5, err_msg=name
            )
        np.testing.assert_array_equal(got.info.mean_alpha.numpy(), np.asarray(want.info.mean_alpha))
    else:
        assert_chaos(as_np(got), as_np(want))
        assert abs(int(got.info.n_iters) - int(want.info.n_iters)) <= 2


def test_finite_diff_linearization_matches_jax_and_carries_gradients():
    jdx = JaxPendulumDx.default(jnp.float32)
    rng = np.random.default_rng(60)
    th = rng.uniform(-np.pi, np.pi, (4, 6))
    xs = np.stack([np.cos(th), np.sin(th), rng.uniform(-3, 3, (4, 6))], -1).astype(np.float32)
    us = rng.uniform(-2.5, 2.5, (4, 6, 1)).astype(np.float32)
    want = jax_linearize(jdx, jnp.asarray(xs), jnp.asarray(us), jdm.GradMethods.FINITE_DIFF)
    dx = convert.pendulum_from_jax(jdx, device="cpu")
    got = linearize_dynamics(dx, torch.tensor(xs), torch.tensor(us), tdm.GradMethods.FINITE_DIFF)
    np.testing.assert_allclose(got.F.numpy(), np.asarray(want.F), atol=2e-3)
    np.testing.assert_allclose(got.f.numpy(), np.asarray(want.f), atol=2e-3)
    analytic = linearize_dynamics(dx, torch.tensor(xs), torch.tensor(us))
    np.testing.assert_allclose(got.F.numpy(), analytic.F.numpy(), atol=3e-2)
    lin = tdm.LinDx(torch.zeros(2, 3, 4), None)
    assert linearize_dynamics(lin, None, None) is lin
    prm = dx.params.clone().requires_grad_(True)
    fd = linearize_dynamics(dx.replace(params=prm), torch.tensor(xs), torch.tensor(us), tdm.GradMethods.FINITE_DIFF)
    (g,) = torch.autograd.grad(fd.F.sum() + fd.f.sum(), prm)
    assert bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0)
    # AUTO_DIFF, the forward-mode Jacobian of forward, is the analytic one
    auto = linearize_dynamics(dx, torch.tensor(xs), torch.tensor(us), tdm.GradMethods.AUTO_DIFF)
    np.testing.assert_allclose(auto.F.numpy(), analytic.F.numpy(), atol=1e-5)
    np.testing.assert_allclose(auto.f.numpy(), analytic.f.numpy(), atol=1e-5)


def test_lin_dx_inputs_broadcast_and_convert():
    T, B, n, m = 6, 5, 3, 2
    C, c, F, f, x0 = problem(70, T, B, n, m)
    config = tdm.MPCConfig(n_state=n, n_ctrl=m, T=T, lqr_iter=3, exit_unconverged=False)
    x, cost, _ = torch_problem(C, c, F, f, x0)
    full = tdm.mpc_solve(config, x, cost, tdm.LinDx(torch.tensor(F[:1, :1]).expand(T, B, n, n + m), None))
    for dx in (tdm.LinDx(torch.tensor(F[0, 0]), None), tdm.LinDx(torch.tensor(F[:, 0])[:1].expand(T, n, n + m), None)):
        sol = tdm.mpc_solve(config, x, cost, dx)
        assert torch.equal(sol.us, full.us)
    jlin = jdm.LinDx(jnp.asarray(F), jnp.asarray(f))
    tlin = convert.lin_dx_from_jax(jlin, device="cpu")
    np.testing.assert_array_equal(tlin.F.numpy(), F)
    np.testing.assert_array_equal(tlin.f.numpy(), f)
    assert convert.lin_dx_from_jax(jdm.LinDx(jnp.asarray(F)), device="cpu").f is None
    with pytest.raises(ValueError, match="LinDx.F trailing dims"):
        tdm.mpc_solve(config, x, cost, tdm.LinDx(torch.tensor(F[..., :4]), None))
    # a gradient through the LinDx arrays, and none without backprop
    Fg = torch.tensor(F, requires_grad=True)
    sol = tdm.mpc_solve(config, x, cost, tdm.LinDx(Fg, torch.tensor(f)))
    assert sol.us.requires_grad
    nb = tdm.mpc_solve(dataclasses.replace(config, backprop=False), x, cost, tdm.LinDx(Fg, torch.tensor(f)))
    assert not nb.us.requires_grad
