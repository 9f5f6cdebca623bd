"""The port's ``mpc_solve`` / ``MPC`` against the JAX package's, end to end.

The configuration is ``__graft_entry__.entry()``'s (pendulum, goal cost,
box +-2, ``eps=1e-5``, no exit on unconverged) cut to T=8, B=48,
``lqr_iter=4``; the JAX side runs its fused kernel in interpret mode
(``use_pallas=True, pallas_interpret=True``). Tolerances are the chaos rule
of tests/torch_parity.py, applied to the per-scenario outputs.
"""

import dataclasses
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import diffmpc_tpu as jdm  # noqa: E402
import diffmpc_tpu_torch as tdm  # noqa: E402
from diffmpc_tpu.models import PendulumDx as JaxPendulumDx  # noqa: E402
from diffmpc_tpu_torch import convert  # noqa: E402
from diffmpc_tpu_torch.models import PendulumDx  # noqa: E402
from torch_parity import assert_chaos  # noqa: E402

B, T = 48, 8


def _x_init(seed=0):
    """``__graft_entry__._x_init``'s recipe, as numpy float32."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, B)
    thdot = rng.uniform(-1.0, 1.0, B)
    return np.stack([np.cos(th), np.sin(th), thdot], -1).astype(np.float32)


def _jax_setup():
    dx = JaxPendulumDx.default(jnp.float32)
    q, p = dx.get_true_obj()
    config = jdm.MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=4, eps=1e-5,
        exit_unconverged=False, detach_unconverged=False,
        use_pallas=True, pallas_interpret=True,
    )
    return config, jdm.QuadCost(jnp.diag(q), p), dx


def _torch_setup():
    """The same problem in the port, carried over by convert.py."""
    config, cost, dx = _jax_setup()
    return (
        convert.mpc_config_from_jax(config),
        convert.quad_cost_from_jax(cost, device="cpu"),
        convert.pendulum_from_jax(dx, device="cpu"),
    )


@pytest.fixture(scope="module")
def reference():
    config, cost, dx = _jax_setup()
    sol = jdm.mpc_solve(
        config, jnp.asarray(_x_init(), jnp.float32), cost, dx, u_lower=-2.0, u_upper=2.0
    )
    return sol


def _as_np(sol):
    return dict(
        us=np.asarray(sol.us), objs=np.asarray(sol.objs),
        converged=np.asarray(sol.info.converged), n_iters=np.asarray(sol.info.n_iters),
        alpha=np.asarray(sol.info.mean_alpha),
        last_improvement=np.asarray(sol.info.last_improvement),
    )


def _assert_matches(got, want):
    # n_iters per scenario is not in MPCInfo; last_improvement < eps freezes
    # a scenario, so "converged alike" stands in for it in the chaos rule
    got = dict(got, n_iters=got["converged"].astype(np.int32))
    want = dict(want, n_iters=want["converged"].astype(np.int32))
    assert_chaos(got, want)
    assert got["converged"].mean() > 0.5


def test_mpc_solve_matches_jax(reference):
    config, cost, dx = _torch_setup()
    sol = tdm.mpc_solve(config, torch.tensor(_x_init()), cost, dx, u_lower=-2.0, u_upper=2.0)
    got, want = _as_np(sol), _as_np(reference)
    _assert_matches(got, want)
    assert got["n_iters"] == want["n_iters"]  # iterations until all froze
    assert sol.us.shape == (T, B, 1) and sol.xs.shape == (T, B, 3)
    assert float(sol.us.abs().max()) <= 2.0
    assert bool(torch.isfinite(sol.objs).all())
    np.testing.assert_allclose(sol.info.qp_iters.numpy(), np.asarray(reference.info.qp_iters))
    # where the last step agrees, at most one control entry (1/T) may sit
    # within rounding of the bound on one side only
    same = got["alpha"] == want["alpha"]
    np.testing.assert_allclose(
        sol.info.clamp_frac.numpy()[same], np.asarray(reference.info.clamp_frac)[same],
        atol=1.0 / T + 1e-6,
    )


def test_mpc_class_matches_mpc_solve():
    config, cost, dx = _torch_setup()
    x = torch.tensor(_x_init())
    ctrl = tdm.MPC(
        3, 1, T, u_lower=-2.0, u_upper=2.0, lqr_iter=4, eps=1e-5,
        exit_unconverged=False, detach_unconverged=False,
    )
    xs, us, objs = ctrl(x, cost, dx)
    sol = tdm.mpc_solve(config, x, cost, dx, u_lower=-2.0, u_upper=2.0)
    assert torch.equal(xs, sol.xs) and torch.equal(us, sol.us) and torch.equal(objs, sol.objs)
    # exit_unconverged raises like the reference when a scenario is left over
    strict = tdm.MPC(3, 1, T, u_lower=-2.0, u_upper=2.0, lqr_iter=1)
    with pytest.raises(RuntimeError, match="did not converge"):
        strict(x, cost, dx)


def test_warm_start_and_per_scenario_params_match_jax():
    jconfig, jcost, jdx = _jax_setup()
    rng = np.random.default_rng(5)
    params = (np.array([10.0, 1.0, 1.0]) * rng.uniform(0.9, 1.1, (B, 3))).astype(np.float32)
    u_init = rng.uniform(-2.0, 2.0, (T, B, 1)).astype(np.float32)
    jdx = jdx.replace(params=jnp.asarray(params))
    want = jdm.mpc_solve(
        jconfig, jnp.asarray(_x_init(1)), jcost, jdx, u_init=jnp.asarray(u_init),
        u_lower=-2.0, u_upper=2.0,
    )
    config, cost, dx = _torch_setup()
    got = tdm.mpc_solve(
        config, torch.tensor(_x_init(1)), cost, dx.replace(params=torch.tensor(params)),
        u_init=torch.tensor(u_init), u_lower=-2.0, u_upper=2.0,
    )
    _assert_matches(_as_np(got), _as_np(want))


def test_same_value_errors_as_jax():
    jconfig, jcost, jdx = _jax_setup()
    config, cost, dx = _torch_setup()
    x = _x_init()
    bad_cases = [
        dict(x=x[:, :2]),  # x_init not (B, n)
        dict(lo=np.full((B, 1), -2.0, np.float32)),  # 2-D bound read as (T, m)
        dict(lo=np.full((3,), -2.0, np.float32)),  # 1-D bound not (m,)
        dict(C=np.eye(5, dtype=np.float32), c=np.zeros(5, np.float32)),  # nm != n + m
        dict(lo=np.float32(-2.0), hi=None),  # one bound only
        dict(params=np.ones((B + 1, 3), np.float32)),  # per-scenario params vs B
    ]
    for case in bad_cases:
        xi = case.get("x", x)
        lo = case.get("lo", np.float32(-2.0))
        hi = case.get("hi", np.float32(2.0))
        C = case.get("C", np.asarray(jcost.C))
        c = case.get("c", np.asarray(jcost.c))
        jd, td = jdx, dx
        if "params" in case:
            jd = jdx.replace(params=jnp.asarray(case["params"]))
            td = dx.replace(params=torch.tensor(case["params"]))
        with pytest.raises(ValueError):
            jdm.mpc_solve(
                jconfig, jnp.asarray(xi), jdm.QuadCost(jnp.asarray(C), jnp.asarray(c)), jd,
                u_lower=None if lo is None else jnp.asarray(lo),
                u_upper=None if hi is None else jnp.asarray(hi),
            )
        with pytest.raises(ValueError):
            tdm.mpc_solve(
                config, torch.tensor(xi), tdm.QuadCost(torch.tensor(C), torch.tensor(c)), td,
                u_lower=None if lo is None else torch.tensor(lo),
                u_upper=None if hi is None else torch.tensor(hi),
            )


@pytest.mark.parametrize(
    "case",
    ["lin_dx", "callable_cost", "slew", "no_bounds", "finite_diff", "verbose",
     "u_zero_I", "two_controls", "analytic_check"],
)
def test_configurations_off_the_fused_path_raise(case):
    """Named for the time when every configuration off the fused path
    raised. Each now runs: the non-fused path takes LinDx, unconstrained,
    FINITE_DIFF, verbose and m = 2 problems and callable costs (checked
    against JAX in tests/test_torch_lqr.py and
    tests/test_torch_callable_cost.py); the slew penalty and u_zero_I ride
    the fused path (tests/test_torch_slew.py) and ANALYTIC_CHECK checks the
    pendulum's Jacobians before it solves. Each gives a finite solution of
    the problem's shape inside the box; u_zero_I's pinned control is exactly
    zero, the slew penalty's state is the unaugmented one, and
    ANALYTIC_CHECK solves as ANALYTIC does."""
    config, cost, dx = _torch_setup()
    config = dataclasses.replace(config, lqr_iter=2)
    x = torch.tensor(_x_init())
    kw = dict(u_lower=-2.0, u_upper=2.0)
    if case == "lin_dx":
        dx = tdm.LinDx(torch.eye(3, 4).expand(T, B, 3, 4), torch.zeros(T, B, 3))
    elif case == "callable_cost":
        cost = lambda tau: (tau ** 2).sum()  # noqa: E731
    elif case == "slew":
        config = dataclasses.replace(config, slew_rate_penalty=0.1)
    elif case == "no_bounds":
        kw = {}
    elif case == "finite_diff":
        config = dataclasses.replace(config, grad_method=tdm.GradMethods.FINITE_DIFF)
    elif case == "verbose":
        config = dataclasses.replace(config, verbose=1)
    elif case == "u_zero_I":
        kw["u_zero_I"] = torch.ones(1, dtype=torch.bool)
    elif case == "two_controls":
        config = dataclasses.replace(config, n_ctrl=2)
        cost = tdm.QuadCost(torch.eye(5), torch.zeros(5))
        dx = tdm.LinDx(torch.eye(3, 5), None)
    if case == "analytic_check":
        kw = dict(u_lower=-2.0, u_upper=2.0, lqr_iter=2, eps=1e-5, exit_unconverged=False, detach_unconverged=False)
        sol = tdm.MPC(3, 1, T, grad_method=tdm.GradMethods.ANALYTIC_CHECK, **kw).solve(x, cost, dx)
        ref = tdm.MPC(3, 1, T, **kw).solve(x, cost, dx)
        assert torch.equal(sol.us, ref.us) and torch.equal(sol.objs, ref.objs)
        return
    sol = tdm.mpc_solve(config, x, cost, dx, **kw)
    assert sol.us.shape == (T, B, config.n_ctrl) and sol.xs.shape == (T, B, 3)
    assert bool(torch.isfinite(sol.objs).all()) and int(sol.info.n_iters) >= 1
    if kw:
        assert float(sol.us.abs().max()) <= 2.0
    if case == "u_zero_I":
        assert bool((sol.us == 0).all())


@pytest.mark.parametrize("which", ["x_init", "C", "c", "params"])
def test_requires_grad_raises_until_the_kkt_backward(which):
    """Named for the time before the KKT backward was ported, when an input
    requiring grad raised: now each of them gets a finite, non-zero
    gradient through the fixed point (the values are held against JAX in
    tests/test_torch_train.py)."""
    config, cost, dx = _torch_setup()
    config = dataclasses.replace(config, lqr_iter=2)
    x = torch.tensor(_x_init())
    if which == "x_init":
        leaf = x.requires_grad_(True)
    elif which == "params":
        leaf = dx.params.clone().requires_grad_(True)
        dx = dx.replace(params=leaf)
    else:
        leaf = getattr(cost, which).clone().requires_grad_(True)
        cost = cost._replace(**{which: leaf})
    sol = tdm.mpc_solve(config, x, cost, dx, u_lower=-2.0, u_upper=2.0)
    assert sol.us.requires_grad
    (grad,) = torch.autograd.grad((sol.us**2).mean(), leaf)
    assert grad.shape == leaf.shape and grad.dtype == leaf.dtype
    assert bool(torch.isfinite(grad).all()) and bool(grad.abs().max() > 0)
    # without backprop the solve runs and returns detached trajectories
    nb = dataclasses.replace(config, backprop=False, lqr_iter=1)
    sol = tdm.mpc_solve(nb, x, cost, dx, u_lower=-2.0, u_upper=2.0)
    assert not sol.us.requires_grad


def test_mpc_class_returns_differentiable_outputs():
    config, cost, dx = _torch_setup()
    config = dataclasses.replace(config, lqr_iter=2)
    x = torch.tensor(_x_init()).requires_grad_(True)
    ctrl = tdm.MPC(
        3, 1, T, u_lower=-2.0, u_upper=2.0, lqr_iter=2, eps=1e-5,
        exit_unconverged=False, detach_unconverged=False,
    )
    _, us, _ = ctrl(x, cost, dx)
    (got,) = torch.autograd.grad((us**2).mean(), x)
    sol = tdm.mpc_solve(config, x, cost, dx, u_lower=-2.0, u_upper=2.0)
    (want,) = torch.autograd.grad((sol.us**2).mean(), x)
    assert torch.equal(got, want)


def test_gradient_needs_the_analytic_linearization():
    """Named for the time when AUTO_DIFF ran forward-only and raised when
    asked for a gradient. Now its attach linearizes by forward-mode autodiff
    of ``forward``: the same gradient as ANALYTIC's closed form, within
    float32 rounding, and none with grad mode off."""
    config, cost, dx = _torch_setup()
    config = dataclasses.replace(config, lqr_iter=1, grad_method=tdm.GradMethods.AUTO_DIFF)
    x = torch.tensor(_x_init())
    sol = tdm.mpc_solve(config, x, cost, dx, u_lower=-2.0, u_upper=2.0)
    assert bool(torch.isfinite(sol.objs).all())
    grads = {}
    for method in (tdm.GradMethods.AUTO_DIFF, tdm.GradMethods.ANALYTIC):
        leaf = x.clone().requires_grad_(True)
        s = tdm.mpc_solve(dataclasses.replace(config, grad_method=method), leaf, cost, dx, u_lower=-2.0, u_upper=2.0)
        (grads[method],) = torch.autograd.grad((s.us**2).mean(), leaf)
    auto, analytic = grads.values()
    assert bool(analytic.abs().max() > 0)
    np.testing.assert_allclose(auto.numpy(), analytic.numpy(), atol=1e-5 * float(analytic.abs().max()))
    with torch.no_grad():  # grad mode off: no attach
        assert not tdm.mpc_solve(config, x.requires_grad_(True), cost, dx, u_lower=-2.0, u_upper=2.0).us.requires_grad


def test_convert_carries_the_jax_state_over():
    jdx = JaxPendulumDx.default(jnp.float32)
    tdx = convert.pendulum_from_jax(jdx, device="cpu")
    np.testing.assert_array_equal(tdx.params.numpy(), PendulumDx.default(device="cpu").params.numpy())
    assert (tdx.max_torque, tdx.max_speed, tdx.dt, tdx.clamp_ctrl) == (
        jdx.max_torque, jdx.max_speed, jdx.dt, jdx.clamp_ctrl,
    )
    for j, t in zip(jdx.get_true_obj(), tdx.get_true_obj()):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # and back: the tensors hold the JAX values exactly
    back = JaxPendulumDx(params=jnp.asarray(tdx.params.numpy()))
    np.testing.assert_array_equal(np.asarray(back.params), np.asarray(jdx.params))
    batched = convert.pendulum_from_jax(jdx.replace(params=jnp.ones((B, 3), jnp.float32)), device="cpu")
    assert batched.param_batch_shape == (B,)
    q, p = jdx.get_true_obj()
    tc = convert.quad_cost_from_jax(jdm.QuadCost(jnp.diag(q), p), device="cpu")
    np.testing.assert_array_equal(tc.C.numpy(), np.diag(np.asarray(q)))
    # by default the weights go to the card, and never fall back to the CPU
    if torch.cuda.is_available():
        assert convert.pendulum_from_jax(jdx).params.device.type == "cuda"
        assert convert.quad_cost_from_jax(jdm.QuadCost(jnp.diag(q), p)).C.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            convert.pendulum_from_jax(jdx)
        with pytest.raises((RuntimeError, AssertionError)):
            convert.quad_cost_from_jax(jdm.QuadCost(jnp.diag(q), p))
    jconfig, _, _ = _jax_setup()
    config = convert.mpc_config_from_jax(jconfig)
    for f in dataclasses.fields(tdm.MPCConfig):
        if f.name not in ("use_cuda", "grad_method", "hoist_lin", "pnqp_enum", "value_update_exact_reg"):
            assert getattr(config, f.name) == getattr(jconfig, f.name), f.name
    # the JAX package holds these two as module globals, not as config: the
    # converted config keeps the port's defaults, which are the globals'
    from diffmpc_tpu.ops.pallas import riccati as jric

    assert (config.pnqp_enum, config.value_update_exact_reg) == ("", -1.0) == (
        jric._pnqp_enum_mode(), jric.VALUE_UPDATE_EXACT_REG)
    assert config.hoist_lin is False  # the JAX package's is an env knob
    assert config.grad_method.value == jconfig.grad_method.value
    assert config.use_cuda is None  # interpret mode: plain on CPU, kernel on CUDA
    assert convert.mpc_config_from_jax(dataclasses.replace(jconfig, pallas_interpret=False)).use_cuda
    assert convert.mpc_config_from_jax(dataclasses.replace(jconfig, use_pallas=False)).use_cuda is False
    # the port's defaults are the JAX package's
    for f in dataclasses.fields(tdm.MPCConfig):
        if f.name not in ("use_cuda", "hoist_lin", "pnqp_enum", "value_update_exact_reg") \
                and f.default is not dataclasses.MISSING:
            jdefault = getattr(jdm.MPCConfig(3, 1, T), f.name)
            jval = jdefault.value if f.name == "grad_method" else jdefault
            tval = f.default.value if f.name == "grad_method" else f.default
            assert tval == jval, f.name


def test_use_cuda_true_on_cpu_tensors_raises():
    config, cost, dx = _torch_setup()
    config = dataclasses.replace(config, use_cuda=True)
    with pytest.raises(ValueError, match="use_cuda=True"):
        tdm.mpc_solve(config, torch.tensor(_x_init()), cost, dx, u_lower=-2.0, u_upper=2.0)
