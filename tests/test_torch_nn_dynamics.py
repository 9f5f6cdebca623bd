"""Learned dynamics in the port against the JAX package, on the same weights.

The models (``NNDynamics``, ``AffineDynamics``) are drawn with numpy seeds,
made in the JAX package and carried to the port by ``convert.py``.
Tolerances:

- ``NNDynamics.forward`` / ``entries_step`` / ``grad_input``, all six
  activations, residual on and off: 1e-6 in float32 (the two CPU backends
  round ``tanh``, ``exp`` and friends apart by a few ulps), 1e-12 in float64;
  the fusable gate equal to the JAX one;
- the fused solve's plain version with an MLP step against the JAX Pallas
  kernel in interpret mode (tests/test_pallas_ilqr.py:285-320: hidden (8,),
  T=6, B=48), ``hoist_lin`` off and on alike: 1e-4 after one iteration, the
  chaos rule of tests/torch_parity.py after three; the port's ``hoist_lin``
  results equal its default ones bit for bit;
- ``mpc_solve`` in float64 on the CPU against the JAX package's XLA path in
  the near-upright stabilization regime of tests/test_imitation.py:79-83:
  objectives within 1e-5, controls within 1e-4, the gradient of
  ``mean(us**2)`` with respect to every weight and bias within 1e-6 of its
  max-abs; ``AffineDynamics`` and an MLP too large for the kernels through
  the non-fused loop (the ladder through ``forward``) alike;
- the linearization by ``AUTO_DIFF`` (shared and per-scenario params, the
  MLP) within 1e-12 in float64, and ``ANALYTIC_CHECK`` equal to
  ``ANALYTIC``;
- five imitation steps with Adam in float64: losses within 1e-6 relative,
  params within 1e-5 (Adam divides by the root of its second moment, so a
  gradient component near zero moves by up to the step size on either side:
  those are compared at the optimizer's eps).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import diffmpc_tpu as jdm  # noqa: E402
import diffmpc_tpu_torch as tdm  # noqa: E402
from diffmpc_tpu.models import AffineDynamics as JaxAffine  # noqa: E402
from diffmpc_tpu.models import NNDynamics as JaxNN  # noqa: E402
from diffmpc_tpu.models import PendulumDx as JaxPendulumDx  # noqa: E402
from diffmpc_tpu.ops.linearize import linearize_dynamics as jax_linearize  # noqa: E402
from diffmpc_tpu.ops.pallas.ilqr import ilqr_solve_fused as jax_ilqr  # noqa: E402
from diffmpc_tpu.parallel import init_train_state as jax_init_train_state  # noqa: E402
from diffmpc_tpu.parallel import make_dp_train_step as jax_make_dp_train_step  # noqa: E402
from diffmpc_tpu_torch import convert  # noqa: E402
from diffmpc_tpu_torch.models import NNDynamics  # noqa: E402
from diffmpc_tpu_torch.models.dynamics import ACTIVATIONS  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.ilqr import ilqr_solve_fused, ilqr_solve_plain  # noqa: E402
from diffmpc_tpu_torch.ops.linearize import linearize_dynamics  # noqa: E402
from diffmpc_tpu_torch.parallel import init_train_state, make_dp_train_step  # noqa: E402
from torch_parity import as_numpy, assert_chaos, assert_tight  # noqa: E402

TOL = {np.float32: 1e-6, np.float64: 1e-12}


def jax_nn(seed, hidden, activation="tanh", residual=True, dtype=np.float64, n=3, m=1):
    """A JAX MLP with He-normal weights and small random biases from a numpy
    seed."""
    rng = np.random.default_rng(seed)
    sizes = [n + m, *hidden, n]
    ws = [rng.normal(size=(a, b)) * np.sqrt(2.0 / a) for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [rng.normal(size=(b,)) * 0.1 for b in sizes[1:]]
    cast = lambda a: jnp.asarray(a.astype(dtype))  # noqa: E731
    return JaxNN(tuple(map(cast, ws)), tuple(map(cast, bs)), activation, residual)


def port(jdx, dtype=None):
    return convert.nn_dynamics_from_jax(jdx, dtype=dtype, device="cpu")


# ---------------------------------------------------------------------------
# The model.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("activation", list(ACTIVATIONS))
def test_nn_model_matches_jax(activation, residual, dtype):
    jdx = jax_nn(1, (8, 8), activation, residual, dtype)
    tdx = port(jdx)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 7, 3)).astype(dtype)
    u = rng.normal(size=(5, 7, 1)).astype(dtype)
    tol = TOL[dtype]

    def close(got, want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)

    close(tdx.forward(torch.tensor(x), torch.tensor(u)), jdx.forward(jnp.asarray(x), jnp.asarray(u)))
    params = np.asarray(jdx.kernel_params())
    np.testing.assert_array_equal(tdx.kernel_params().numpy(), params)
    xe, ue = [x[..., i] for i in range(3)], [u[..., 0]]
    want = jdx.entries_step(list(params), [jnp.asarray(a) for a in xe], [jnp.asarray(a) for a in ue])
    got = tdx.entries_step(list(torch.tensor(params)), [torch.tensor(a) for a in xe], [torch.tensor(a) for a in ue])
    for g, w in zip(got, want):
        close(g, w)
    for g, w in zip(tdx.grad_input(torch.tensor(x), torch.tensor(u)), jdx.grad_input(jnp.asarray(x), jnp.asarray(u))):
        assert g.shape == w.shape
        close(g, w)


@pytest.mark.parametrize("hidden", [(8,), (64, 64), (32,), (33,), (16, 16), (31, 31), (32, 28)])
def test_fusable_gate_matches_jax(hidden):
    jdx = jax_nn(3, hidden)
    assert port(jdx).kernel_fusable == jdx.kernel_fusable
    assert port(jdx).n_params == sum(w.size + b.size for w, b in zip(jdx.weights, jdx.biases))


def test_init_draws_he_normal_from_the_generator():
    gen = torch.Generator().manual_seed(3)
    nn = NNDynamics.init(3, 1, hidden=(16, 16), activation="gelu", device="cpu", generator=gen)
    again = NNDynamics.init(3, 1, hidden=(16, 16), activation="gelu", device="cpu",
                            generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(nn.weights, again.weights))
    assert [tuple(w.shape) for w in nn.weights] == [(4, 16), (16, 16), (16, 3)]
    assert nn.hidden == (16, 16) and (nn.n_state, nn.n_ctrl) == (3, 1) and nn.kernel_fusable
    assert all(not b.any() for b in nn.biases)
    assert abs(float(nn.weights[1].std()) - (2.0 / 16) ** 0.5) < 0.1
    with pytest.raises(ValueError, match="activation"):
        NNDynamics.init(3, 1, activation="swish", device="cpu")


# ---------------------------------------------------------------------------
# The fused solve's plain version against the JAX kernel in interpret mode.
# ---------------------------------------------------------------------------

FB, FT = 48, 6


def fused_problem():
    """tests/test_pallas_ilqr.py:285-320's inputs: its MLP (PRNGKey(7),
    hidden (8,), tanh, residual), the goal cost, box +-2."""
    nn = JaxNN.init(jax.random.PRNGKey(7), n_state=3, n_ctrl=1, hidden=(8,), activation="tanh", residual=True)
    rng = np.random.default_rng(703)
    q = np.array([1.0, 1.0, 0.1, 0.001], np.float32)
    p = np.array([-1.0, 0.0, 0.0, 0.0], np.float32)
    prob = dict(
        x_init=(rng.normal(size=(FB, 3)) * 0.5).astype(np.float32),
        C=np.ascontiguousarray(np.broadcast_to(np.diag(q), (FT, FB, 4, 4))),
        c=np.ascontiguousarray(np.broadcast_to(p, (FT, FB, 4))),
        u_lower=np.full((FT, FB, 1), -2.0, np.float32),
        u_upper=np.full((FT, FB, 1), 2.0, np.float32),
    )
    return nn, prob


@functools.lru_cache(maxsize=None)
def jax_fused(lqr_iter, hoist_lin):
    nn, prob = fused_problem()
    a = {k: jnp.asarray(v) for k, v in prob.items()}
    out = jax_ilqr(a["x_init"], a["C"], a["c"], nn, a["u_lower"], a["u_upper"], lqr_iter=lqr_iter,
                   eps=0.0 if lqr_iter == 1 else 1e-5, interpret=True, hoist_lin=hoist_lin)
    return {f: np.asarray(getattr(out, f)) for f in out._fields}


@pytest.mark.parametrize("hoist_lin", [False, True], ids=["in_sweep", "hoist_lin"])
@pytest.mark.parametrize("lqr_iter", [1, 3])
def test_fused_nn_plain_matches_jax_kernel(lqr_iter, hoist_lin):
    nn, prob = fused_problem()
    t = {k: torch.tensor(v) for k, v in prob.items()}
    args = (t["x_init"], t["C"], t["c"], port(nn), t["u_lower"], t["u_upper"])
    knobs = dict(lqr_iter=lqr_iter, eps=0.0 if lqr_iter == 1 else 1e-5)
    got = ilqr_solve_fused(*args, hoist_lin=hoist_lin, **knobs)
    want = jax_fused(lqr_iter, hoist_lin)
    if lqr_iter == 1:
        assert_tight(as_numpy(got), want)
    else:
        assert_chaos(as_numpy(got), want)
        assert (want["n_iters"] >= 2).mean() > 0.5
    if hoist_lin:  # the pre-pass computes the same numbers in the same order
        default = ilqr_solve_plain(*args, **knobs)
        assert all(torch.equal(a, b) for a, b in zip(got, default))


# ---------------------------------------------------------------------------
# mpc_solve, the gradient and the non-fused loop, in float64.
# ---------------------------------------------------------------------------

SB, ST = 32, 6


def stabilization_x_init():
    """tests/test_imitation.py:79-83: near-upright starts."""
    rng = np.random.default_rng(42)
    th = rng.uniform(-0.6, 0.6, SB)
    return np.stack([np.cos(th), np.sin(th), rng.uniform(-0.5, 0.5, SB)], -1)


def configs(lqr_iter=3):
    kw = dict(n_state=3, n_ctrl=1, T=ST, lqr_iter=lqr_iter, eps=1e-5, exit_unconverged=False,
              detach_unconverged=False)
    return jdm.MPCConfig(**kw, dtype=jnp.float64, use_pallas=False), tdm.MPCConfig(**kw)


def costs():
    q, p = JaxPendulumDx.default(jnp.float64).get_true_obj()
    jcost = jdm.QuadCost(jnp.diag(q), p)
    return jcost, convert.quad_cost_from_jax(jcost, device="cpu")


@functools.lru_cache(maxsize=None)
def jax_solve_and_grads(hidden):
    jconfig, _ = configs()
    jcost, _ = costs()
    nn = jax_nn(10, hidden)

    def loss(params, x):
        sol = jdm.mpc_solve(jconfig, x, jcost, nn.replace(weights=params["w"], biases=params["b"]),
                            u_lower=-2.0, u_upper=2.0)
        return jnp.mean(sol.us**2), sol

    (_, sol), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {"w": nn.weights, "b": nn.biases}, jnp.asarray(stabilization_x_init())
    )
    return nn, sol, grads


def assert_solutions_match(got, want):
    np.testing.assert_allclose(got.objs.detach().numpy(), np.asarray(want.objs), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.us.detach().numpy(), np.asarray(want.us), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.info.converged.numpy(), np.asarray(want.info.converged))


@pytest.mark.parametrize("hidden", [(16,), (64, 64)], ids=["fused", "non_fused_64x64"])
def test_nn_mpc_solve_and_weight_gradients_match_jax_float64(hidden):
    """(16,) passes the fusable gate: the port takes the fused solve's plain
    version, JAX its XLA loop. (64, 64) does not: both take the non-fused
    loop with the ladder through ``forward``."""
    nn, want, jgrads = jax_solve_and_grads(hidden)
    tdx = port(nn)
    assert tdx.kernel_fusable == (hidden == (16,))
    w = [a.clone().requires_grad_(True) for a in tdx.weights]
    b = [a.clone().requires_grad_(True) for a in tdx.biases]
    _, tconfig = configs()
    _, tcost = costs()
    got = tdm.mpc_solve(tconfig, torch.tensor(stabilization_x_init()), tcost,
                        tdx.replace(weights=tuple(w), biases=tuple(b)), u_lower=-2.0, u_upper=2.0)
    assert_solutions_match(got, want)
    grads = torch.autograd.grad((got.us**2).mean(), w + b)
    for g, j in zip(grads, list(jgrads["w"]) + list(jgrads["b"])):
        j = np.asarray(j)
        assert np.abs(j).max() > 0
        np.testing.assert_allclose(g.numpy(), j, atol=1e-6 * np.abs(j).max(), rtol=0)


@functools.lru_cache(maxsize=None)
def jax_affine():
    rng = np.random.default_rng(20)
    A = np.eye(3) + rng.normal(size=(3, 3)) * 0.1
    B = rng.normal(size=(3, 1)) * 0.3
    c = rng.normal(size=(3,)) * 0.05
    jdx = JaxAffine(jnp.asarray(A), jnp.asarray(B), jnp.asarray(c))
    jconfig, _ = configs(lqr_iter=4)
    jcost, _ = costs()
    sol = jax.jit(lambda x: jdm.mpc_solve(jconfig, x, jcost, jdx, u_lower=-2.0, u_upper=2.0))(
        jnp.asarray(stabilization_x_init())
    )
    return jdx, sol


def test_affine_dynamics_through_the_non_fused_loop_matches_jax_float64():
    jdx, want = jax_affine()
    tdx = convert.affine_dynamics_from_jax(jdx, device="cpu")
    _, tconfig = configs(lqr_iter=4)
    _, tcost = costs()
    got = tdm.mpc_solve(tconfig, torch.tensor(stabilization_x_init()), tcost, tdx, u_lower=-2.0, u_upper=2.0)
    assert_solutions_match(got, want)
    assert int(got.info.n_iters) == int(want.info.n_iters)
    x, u = torch.randn(4, 5, 3, dtype=torch.float64), torch.randn(4, 5, 1, dtype=torch.float64)
    A, B = tdx.grad_input(x, u)
    assert torch.equal(A, tdx.A.expand(4, 5, 3, 3)) and torch.equal(B, tdx.B.expand(4, 5, 3, 1))
    assert convert.affine_dynamics_from_jax(jdx.replace(c=None), device="cpu").c is None


# ---------------------------------------------------------------------------
# Linearization by autodiff.
# ---------------------------------------------------------------------------


def _linearize_both(jdx, tdx, method, xs, us):
    want = jax_linearize(jdx, jnp.asarray(xs), jnp.asarray(us), getattr(jdm.GradMethods, method))
    got = linearize_dynamics(tdx, torch.tensor(xs), torch.tensor(us), getattr(tdm.GradMethods, method))
    return got, want


@pytest.mark.parametrize("model", ["pendulum", "pendulum_per_scenario", "nn"])
def test_auto_diff_linearization_matches_jax(model):
    rng = np.random.default_rng(30)
    th = rng.uniform(-np.pi, np.pi, (4, 6))
    xs = np.stack([np.cos(th), np.sin(th), rng.uniform(-3, 3, (4, 6))], -1)
    us = rng.uniform(-2.5, 2.5, (4, 6, 1))
    if model == "nn":
        jdx = jax_nn(31, (8, 8), "softplus")
        tdx = port(jdx)
    else:
        jdx = JaxPendulumDx.default(jnp.float64)
        if model == "pendulum_per_scenario":
            jdx = jdx.replace(params=jnp.asarray(np.array([10.0, 1.0, 1.0]) * rng.uniform(0.9, 1.1, (6, 3))))
        tdx = convert.pendulum_from_jax(jdx, device="cpu")
    got, want = _linearize_both(jdx, tdx, "AUTO_DIFF", xs, us)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-12, rtol=1e-12)
    # ANALYTIC_CHECK linearizes as ANALYTIC (its Jacobian check is MPC.solve's)
    check, analytic = (linearize_dynamics(tdx, torch.tensor(xs), torch.tensor(us), m)
                       for m in (tdm.GradMethods.ANALYTIC_CHECK, tdm.GradMethods.ANALYTIC))
    assert torch.equal(check.F, analytic.F) and torch.equal(check.f, analytic.f)
    np.testing.assert_allclose(check.F.numpy(), got.F.numpy(), atol=1e-10)


# ---------------------------------------------------------------------------
# The imitation step with an MLP, its params a pytree.
# ---------------------------------------------------------------------------


def test_nn_imitation_steps_match_jax_float64():
    jconfig, tconfig = configs()
    jcost, tcost = costs()
    x = stabilization_x_init()
    true = JaxPendulumDx.default(jnp.float64)
    u_expert = jax.jit(lambda xi: jdm.mpc_solve(jconfig, xi, jcost, true, u_lower=-2.0, u_upper=2.0).us)(jnp.asarray(x))
    nn = jax_nn(40, (16,))
    opt = optax.adam(3e-3)
    jstep = jax_make_dp_train_step(
        jconfig, lambda prm: (jcost, nn.replace(weights=prm["w"], biases=prm["b"])), opt, None, -2.0, 2.0
    )
    jstate = jax_init_train_state({"w": nn.weights, "b": nn.biases}, opt)
    tnn = port(nn)
    adam = functools.partial(torch.optim.Adam, lr=3e-3)
    step = make_dp_train_step(
        tconfig, lambda prm: (tcost, tnn.replace(weights=tuple(prm["w"]), biases=tuple(prm["b"]))), adam, None,
        -2.0, 2.0,
    )
    state = init_train_state({"w": tnn.weights, "b": tnn.biases}, adam)
    assert all(leaf.requires_grad and leaf.is_leaf for leaf in state.params["w"] + state.params["b"])
    xt, ut = torch.tensor(x), torch.tensor(np.asarray(u_expert))
    for _ in range(5):
        jstate, jstats = jstep(jstate, jnp.asarray(x), u_expert)
        state, stats = step(state, xt, ut)
        np.testing.assert_allclose(float(stats.loss), float(jstats.loss), rtol=1e-6)
        np.testing.assert_allclose(float(stats.grad_norm), float(jstats.grad_norm), rtol=1e-6)
        for k in ("w", "b"):
            for g, w in zip(state.params[k], jstate.params[k]):
                np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5, rtol=0)
    assert float(stats.grad_norm) > 0
