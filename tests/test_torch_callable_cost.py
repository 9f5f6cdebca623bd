"""Callable costs and ``GradMethods.ANALYTIC_CHECK`` in the port, against the
JAX package.

- ``check_analytic_grads``: the pendulum's closed-form Jacobians pass in
  both packages, shared and per-scenario params; a model whose ``B`` is 10%
  off fails in both. ``MPC.solve`` with ``ANALYTIC_CHECK`` runs the check
  (tests/test_mpc.py:140) and then solves as ``ANALYTIC`` does, bit for bit;
  on a ``LinDx`` it skips the check and solves, as JAX's does
  (``diffmpc_tpu/mpc.py:752-760``), within 1e-9 of JAX's solve (float64).
- ``quadraticize_cost``: the cosh cost of tests/test_mpc.py:160 at random
  samples, ``C`` and ``c`` within 1e-12 of JAX's (float64), and the
  gradient through them to the cost's weights within 1e-10.
- Callable-cost solves (the same cost written once in ``jnp`` and once in
  ``torch``), float64: tests/test_mpc.py:160's swing-up through the
  non-fused loop, one iteration within 1e-9 of JAX's, fifteen by the chaos
  rule of tests/torch_parity.py and below the do-nothing baseline; the
  gradients with respect to the cost's weights and ``x_init`` on the
  scenarios at the same fixed point (controls within 1e-6) within 1e-6 of
  each max-abs; the line search judges by the callable (no rollout kernel
  or its plain version runs), the Riccati sweep once an iteration. A
  callable equal to a ``QuadCost`` solves as the ``QuadCost`` does on the
  non-fused path, within 1e-9; with the slew penalty, within 1e-9 of JAX.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import diffmpc_tpu as jdm  # noqa: E402
import diffmpc_tpu_torch as tdm  # noqa: E402
from diffmpc_tpu.models import PendulumDx as JaxPendulumDx  # noqa: E402
from diffmpc_tpu.ops.linearize import check_analytic_grads as jax_check  # noqa: E402
from diffmpc_tpu.ops.linearize import quadraticize_cost as jax_quadraticize  # noqa: E402
from diffmpc_tpu_torch import convert  # noqa: E402
from diffmpc_tpu_torch.models import PendulumDx  # noqa: E402
from diffmpc_tpu_torch.ops import lqr as lqr_mod  # noqa: E402
from diffmpc_tpu_torch.ops.linearize import check_analytic_grads, quadraticize_cost  # noqa: E402
from oracles import random_lqr_problem  # noqa: E402
from torch_parity import assert_chaos  # noqa: E402

f64 = torch.float64
GOAL = np.array([1.0, 0.0, 0.0, 0.0])
Q = np.array([1.0, 1.0, 0.1, 0.001])


def jax_cost(q):
    """tests/test_mpc.py:160's cost: a goal quadratic and a cosh barrier on
    the control, in jnp."""
    goal = jnp.asarray(GOAL)

    def cost_fn(tau):
        d = tau - goal
        return 0.5 * jnp.sum(q * d * d) + 0.01 * jnp.sum(jnp.cosh(tau[3:]) - 1.0)

    return cost_fn


def torch_cost(q):
    """The same cost in torch."""
    goal = torch.tensor(GOAL, dtype=q.dtype)

    def cost_fn(tau):
        d = tau - goal
        return 0.5 * (q * d * d).sum() + 0.01 * (torch.cosh(tau[3:]) - 1.0).sum()

    return cost_fn


# ---------------------------------------------------------------------------
# check_analytic_grads and ANALYTIC_CHECK
# ---------------------------------------------------------------------------


class _OffB:
    """A model whose closed-form B is 10% off its forward's (any package)."""

    def __init__(self, inner):
        self.inner = inner
        self.forward = inner.forward
        self.param_batch_shape = ()

    def grad_input(self, x, u):
        A, B = self.inner.grad_input(x, u)
        return A, 1.1 * B


def _swingup_x(B, seed=31):
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, B)
    return np.stack([np.cos(th), np.sin(th), rng.uniform(-9, 9, B)], -1), rng.uniform(-3, 3, (B, 1))


@pytest.mark.parametrize("per_scenario", [False, True])
def test_check_analytic_grads_matches_jax(per_scenario):
    """The pendulum passes in both packages (beyond its speed and torque
    clamps), and a model with B 10% off raises AssertionError in both."""
    B, T = 16, 3
    x, u = _swingup_x(B)
    xs, us = np.broadcast_to(x, (T, B, 3)).copy(), np.broadcast_to(u, (T, B, 1)).copy()
    jdx = JaxPendulumDx.default(jnp.float64)
    if per_scenario:
        jdx = jdx.replace(params=jnp.asarray(np.array([10.0, 1.0, 1.0]) * np.random.default_rng(3).uniform(
            0.9, 1.1, (B, 3))))
    dx = convert.pendulum_from_jax(jdx, device="cpu")
    jax_check(jdx, jnp.asarray(xs), jnp.asarray(us))
    check_analytic_grads(dx, torch.tensor(xs), torch.tensor(us))
    if per_scenario:
        return
    with pytest.raises(AssertionError, match="analytic B"):
        jax_check(_OffB(jdx), jnp.asarray(xs), jnp.asarray(us))
    with pytest.raises(AssertionError, match="analytic B"):
        check_analytic_grads(_OffB(dx), torch.tensor(xs), torch.tensor(us))


def test_analytic_check_runs_the_check_then_solves_as_analytic():
    """tests/test_mpc.py:140: MPC.solve with ANALYTIC_CHECK does not raise
    on the pendulum and solves as ANALYTIC does, bit for bit; on a model
    whose Jacobians are off it raises."""
    B, T = 4, 5
    dx = PendulumDx.default(f64, device="cpu")
    q, p = dx.get_true_obj()
    x = torch.tensor(_swingup_x(B)[0] * np.array([1.0, 1.0, 0.1]))
    cost = tdm.QuadCost(torch.diag(q), p)
    kw = dict(u_lower=-2.0, u_upper=2.0, lqr_iter=3, exit_unconverged=False)
    checked = tdm.MPC(3, 1, T, grad_method=tdm.GradMethods.ANALYTIC_CHECK, **kw).solve(x, cost, dx)
    plain = tdm.MPC(3, 1, T, **kw).solve(x, cost, dx)
    assert torch.equal(checked.us, plain.us) and torch.equal(checked.objs, plain.objs)
    with pytest.raises(AssertionError, match="analytic B"):
        tdm.MPC(3, 1, T, grad_method=tdm.GradMethods.ANALYTIC_CHECK, **kw).solve(x, cost, _OffB(dx))


def test_analytic_check_on_lindx_solves_like_jax():
    """ANALYTIC_CHECK on a LinDx problem skips the check and solves in both
    packages, within 1e-9 of each other in float64."""
    T, B, n, m = 6, 5, 3, 2
    C, c, F, f, x0 = random_lqr_problem(np.random.default_rng(620), T, B, n, m)
    kw = dict(u_lower=-0.5, u_upper=0.5, lqr_iter=4, exit_unconverged=False)
    want = jdm.MPC(n, m, T, grad_method=jdm.GradMethods.ANALYTIC_CHECK, **kw)(
        jnp.asarray(x0), jdm.QuadCost(jnp.asarray(C), jnp.asarray(c)), jdm.LinDx(jnp.asarray(F), jnp.asarray(f)))
    got = tdm.MPC(n, m, T, grad_method=tdm.GradMethods.ANALYTIC_CHECK, **kw)(
        torch.tensor(x0), tdm.QuadCost(torch.tensor(C), torch.tensor(c)), tdm.LinDx(torch.tensor(F), torch.tensor(f)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9)


# ---------------------------------------------------------------------------
# quadraticize_cost
# ---------------------------------------------------------------------------


def test_quadraticize_cost_matches_jax():
    """C = H and c = g - H tau at random samples (T=3, B=5), float64, and
    the gradient of a fixed contraction of (C, c) with respect to the cost's
    weights q, which the cost closes over."""
    rng = np.random.default_rng(621)
    xs, us = rng.standard_normal((3, 5, 3)), rng.standard_normal((3, 5, 1))
    WC, Wc = rng.standard_normal((3, 5, 4, 4)), rng.standard_normal((3, 5, 4))

    def jax_loss(q):
        C, c = jax_quadraticize(jax_cost(q), jnp.asarray(xs), jnp.asarray(us))
        return jnp.sum(C * WC) + jnp.sum(c * Wc), (C, c)

    (_, (Cj, cj)), gj = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jnp.asarray(Q))
    q = torch.tensor(Q, requires_grad=True)
    C, c = quadraticize_cost(torch_cost(q), torch.tensor(xs), torch.tensor(us))
    assert C.shape == (3, 5, 4, 4) and c.shape == (3, 5, 4)
    np.testing.assert_allclose(C.detach().numpy(), np.asarray(Cj), atol=1e-12)
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(cj), atol=1e-12)
    g, = torch.autograd.grad((C * torch.tensor(WC)).sum() + (c * torch.tensor(Wc)).sum(), q)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), atol=1e-10)


# ---------------------------------------------------------------------------
# Callable-cost solves
# ---------------------------------------------------------------------------

CB, CT = 4, 10


def _callable_x():
    """tests/test_mpc.py:160's starts, off the hanging saddle."""
    th0 = np.pi * (0.55 + 0.08 * np.arange(CB))
    return np.stack([np.cos(th0), np.sin(th0), np.zeros(CB)], -1)


def _jax_callable(lqr_iter):
    config = jdm.MPCConfig(n_state=3, n_ctrl=1, T=CT, lqr_iter=lqr_iter, eps=1e-8, exit_unconverged=False,
                           detach_unconverged=False)
    dx = JaxPendulumDx.default(jnp.float64)

    def loss(q, x):
        sol = jdm.mpc_solve(config, x, jax_cost(q), dx, u_lower=-2.0, u_upper=2.0)
        return jnp.sum(sol.us ** 2) + jnp.sum(sol.xs[..., 2] ** 2), sol

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)), config


_JAX_CALLABLE = {it: _jax_callable(it) for it in (1, 15)}


def _port_callable(lqr_iter, monkeypatch=None):
    fn, jconfig = _JAX_CALLABLE[lqr_iter]
    calls = {"riccati": 0, "rollout": 0}
    if monkeypatch is not None:
        for name, key in (("riccati_backward_plain", "riccati"), ("linesearch_rollout_plain", "rollout")):
            orig = getattr(lqr_mod, name)

            def counting(*a, _orig=orig, _key=key, **k):
                calls[_key] += 1
                return _orig(*a, **k)

            monkeypatch.setattr(lqr_mod, name, counting)
    q = torch.tensor(Q, requires_grad=True)
    x = torch.tensor(_callable_x(), requires_grad=True)
    dx = PendulumDx.default(f64, device="cpu")
    sol = tdm.mpc_solve(convert.mpc_config_from_jax(jconfig), x, torch_cost(q), dx, u_lower=-2.0, u_upper=2.0)
    grads = torch.autograd.grad((sol.us ** 2).sum() + (sol.xs[..., 2] ** 2).sum(), (q, x))
    (_, want), jgrads = fn(jnp.asarray(Q), jnp.asarray(_callable_x()))
    return sol, grads, want, jgrads, calls


def _np(sol):
    return dict(us=sol.us.detach().numpy(), xs=sol.xs.detach().numpy(), objs=sol.objs.detach().numpy(),
                converged=np.asarray(sol.info.converged), alpha=np.asarray(sol.info.mean_alpha))


def _jnp(sol):
    return dict(us=np.asarray(sol.us), xs=np.asarray(sol.xs), objs=np.asarray(sol.objs),
                converged=np.asarray(sol.info.converged), alpha=np.asarray(sol.info.mean_alpha))


def test_callable_cost_one_iteration_matches_jax(monkeypatch):
    """One iteration: the trajectory and objective within 1e-9 of JAX's,
    one Riccati sweep and no rollout kernel (the ladder judges by the
    callable)."""
    sol, _, want, _, calls = _port_callable(1, monkeypatch)
    g, w = _np(sol), _jnp(want)
    for k in ("us", "xs", "objs"):
        np.testing.assert_allclose(g[k], w[k], atol=1e-9, err_msg=k)
    assert calls == {"riccati": 1, "rollout": 0}


def test_callable_cost_solve_and_gradients_match_jax():
    """Fifteen iterations: the chaos rule, every scenario below the
    do-nothing baseline (tests/test_mpc.py:160), and the gradients with
    respect to the cost's weights (summed over the agreeing scenarios'
    share: the per-scenario x_init rows) within 1e-6 of each max-abs."""
    sol, (gq, gx), want, (jq, jx), _ = _port_callable(15)
    g, w = _np(sol), _jnp(want)
    ones = np.ones(CB, np.int32)
    assert_chaos(dict(g, n_iters=g["converged"] * ones), dict(w, n_iters=w["converged"] * ones))
    same = np.abs(g["us"] - w["us"]).max(axis=(0, 2)) < 1e-6
    assert same.all(), np.abs(g["us"] - w["us"]).max(axis=(0, 2))
    np.testing.assert_allclose(gq.numpy(), np.asarray(jq), atol=1e-6 * np.abs(np.asarray(jq)).max())
    np.testing.assert_allclose(gx.numpy(), np.asarray(jx), atol=1e-6 * np.abs(np.asarray(jx)).max())
    dx = PendulumDx.default(f64, device="cpu")
    x, us0 = torch.tensor(_callable_x()), torch.zeros(CT, CB, 1, dtype=f64)
    xs0 = [x]
    for t in range(CT - 1):
        xs0.append(dx.forward(xs0[-1], us0[t]))
    cost = torch_cost(torch.tensor(Q))
    obj0 = torch.func.vmap(torch.func.vmap(cost))(torch.cat([torch.stack(xs0), us0], -1)).sum(0)
    assert bool((sol.objs < obj0).all())


def test_callable_equal_to_quadcost_solves_as_the_quadcost():
    """A callable 0.5 tau'C tau + c'tau on a LinDx box-DDP (float64)
    through the non-fused loop solves as the QuadCost does there: controls
    and objectives within 1e-9."""
    T, B, n, m = 6, 5, 3, 2
    C, c, F, f, x0 = random_lqr_problem(np.random.default_rng(622), T, B, n, m)
    C, c = C[0, 0], c[0, 0]
    Ct, ct = torch.tensor(C), torch.tensor(c)
    config = tdm.MPCConfig(n_state=n, n_ctrl=m, T=T, lqr_iter=6, exit_unconverged=False)
    dx = tdm.LinDx(torch.tensor(F), torch.tensor(f))
    args = dict(u_lower=-0.5, u_upper=0.5)
    quad = tdm.mpc_solve(config, torch.tensor(x0), tdm.QuadCost(Ct, ct), dx, **args)
    call = tdm.mpc_solve(config, torch.tensor(x0), lambda tau: 0.5 * tau @ (Ct @ tau) + ct @ tau, dx, **args)
    np.testing.assert_allclose(call.us.numpy(), quad.us.numpy(), atol=1e-9)
    np.testing.assert_allclose(call.objs.numpy(), quad.objs.numpy(), atol=1e-9)


def test_callable_cost_with_slew_matches_jax():
    """The slew penalty on a callable cost (the augmented callable,
    ``mpc._augment_slew``): within 1e-9 of JAX's in float64, and the
    augmented state stripped."""
    config = jdm.MPCConfig(n_state=3, n_ctrl=1, T=CT, lqr_iter=3, eps=1e-8, exit_unconverged=False,
                           detach_unconverged=False, slew_rate_penalty=2.0)
    prev = np.full((CB, 1), 0.7)
    solve = jax.jit(lambda x, p: jdm.mpc_solve(config, x, jax_cost(jnp.asarray(Q)), JaxPendulumDx.default(jnp.float64),
                                               u_lower=-2.0, u_upper=2.0, prev_ctrl=p))
    want = solve(jnp.asarray(_callable_x()), jnp.asarray(prev))
    with torch.no_grad():
        got = tdm.mpc_solve(convert.mpc_config_from_jax(config), torch.tensor(_callable_x()),
                            torch_cost(torch.tensor(Q)), PendulumDx.default(f64, device="cpu"), u_lower=-2.0,
                            u_upper=2.0, prev_ctrl=torch.tensor(prev))
    assert got.xs.shape == (CT, CB, 3)
    np.testing.assert_allclose(got.us.numpy(), np.asarray(want.us), atol=1e-9)
    np.testing.assert_allclose(got.objs.numpy(), np.asarray(want.objs), atol=1e-9)
    free = dataclasses.replace(convert.mpc_config_from_jax(config), slew_rate_penalty=None)
    with torch.no_grad():
        no_slew = tdm.mpc_solve(free, torch.tensor(_callable_x()), torch_cost(torch.tensor(Q)),
                                PendulumDx.default(f64, device="cpu"), u_lower=-2.0, u_upper=2.0)
    assert float((got.us[0] - 0.7).abs().mean()) < float((no_slew.us[0] - 0.7).abs().mean())
