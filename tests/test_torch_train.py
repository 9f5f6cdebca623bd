"""Gradients through the port's ``mpc_solve`` and its imitation-learning
step, against the JAX package's.

The problem is tests/test_torch_mpc.py's (pendulum, goal cost, box +-2) at
T=8, B=48. The JAX side runs its fused kernels in interpret mode
(``use_pallas=True, pallas_interpret=True``); the port runs its plain
versions. The loss is ``mean(us**2)``, the JAX benchmark's.

Tolerances:
- ``lqr_iter=1, eps=0``: every gradient entry within 1e-3 of that
  gradient's max-abs;
- ``lqr_iter=4``: the same bound on the rows of the scenarios whose
  controls agree within 1e-4 (swing-up iLQR is chaotic, and a scenario that
  settles elsewhere has another gradient);
- three training steps at ``lqr_iter=1``: params within 5e-4.
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
from diffmpc_tpu.models import PendulumDx as JaxPendulumDx  # noqa: E402
from diffmpc_tpu.parallel import init_train_state as jax_init_train_state  # noqa: E402
from diffmpc_tpu.parallel import make_dp_train_step as jax_make_dp_train_step  # noqa: E402
from diffmpc_tpu_torch.models import PendulumDx  # noqa: E402
from diffmpc_tpu_torch.parallel import (  # noqa: E402
    generate_expert_data,
    init_train_state,
    make_dp_train_step,
)

B, T = 48, 8
TRUE = np.array([10.0, 1.0, 1.0], np.float32)
Q = np.array([1.0, 1.0, 0.1, 0.001], np.float32)
P = np.array([-1.0, 0.0, 0.0, 0.0], np.float32)


def _x_init(seed=0, batch=B):
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, batch)
    return np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, batch)], -1).astype(np.float32)


def _per_scenario_C_c():
    return (
        np.ascontiguousarray(np.broadcast_to(np.diag(Q), (T, B, 4, 4))),
        np.ascontiguousarray(np.broadcast_to(P, (T, B, 4))),
    )


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(lqr_iter, eps):
    """jit of (us, grads of mean(us**2) w.r.t. params, x_init, C, c): one
    compile per configuration and input shapes."""
    config = jdm.MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=lqr_iter, eps=eps,
        exit_unconverged=False, detach_unconverged=False,
        use_pallas=True, pallas_interpret=True,
    )

    def loss(params, x, C, c):
        sol = jdm.mpc_solve(
            config, x, jdm.QuadCost(C, c), JaxPendulumDx(params=params), u_lower=-2.0, u_upper=2.0
        )
        return jnp.mean(sol.us**2), sol.us

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3), has_aux=True))


def jax_grads(lqr_iter, eps, params, x, C, c):
    grads, us = _jax_grad_fn(lqr_iter, eps)(*map(jnp.asarray, (params, x, C, c)))
    return np.asarray(us), [np.asarray(g) for g in grads]


def torch_grads(lqr_iter, eps, params, x, C, c, detach_unconverged=False):
    config = tdm.MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=lqr_iter, eps=eps,
        exit_unconverged=False, detach_unconverged=detach_unconverged,
    )
    leaves = [torch.tensor(a, requires_grad=True) for a in (params, x, C, c)]
    sol = tdm.mpc_solve(
        config, leaves[1], tdm.QuadCost(leaves[2], leaves[3]), PendulumDx(params=leaves[0]),
        u_lower=-2.0, u_upper=2.0,
    )
    grads = torch.autograd.grad((sol.us**2).mean(), leaves)
    return sol, sol.us.detach().numpy(), [g.numpy() for g in grads]


def assert_rows_close(got, want, rows=None, axis=0, name=""):
    """|got - want| <= 1e-3 max|want| on the selected scenario rows."""
    assert got.shape == want.shape, name
    bound = 1e-3 * np.abs(want).max()
    if rows is not None:
        got, want = np.compress(rows, got, axis), np.compress(rows, want, axis)
    np.testing.assert_allclose(got, want, rtol=0, atol=bound, err_msg=name)


@pytest.mark.parametrize("params_kind", ["shared", "per_scenario"])
def test_gradients_match_jax_after_one_iteration(params_kind):
    rng = np.random.default_rng(11)
    if params_kind == "shared":
        params, (C, c) = TRUE, (np.diag(Q), P)
    else:
        params = (TRUE * rng.uniform(0.9, 1.1, (B, 3))).astype(np.float32)
        C, c = _per_scenario_C_c()
    args = (params, _x_init(1), C, c)
    want_us, want = jax_grads(1, 0.0, *args)
    _, got_us, got = torch_grads(1, 0.0, *args)
    np.testing.assert_allclose(got_us, want_us, atol=1e-4)
    for name, g, w in zip(("params", "x_init", "C", "c"), got, want):
        assert np.abs(w).max() > 0, name
        assert_rows_close(g, w, name=name)


def test_gradients_match_jax_after_four_iterations():
    """Per-scenario params, C and c (all equal to the shared ones), so that
    every gradient has a row per scenario; their sum over the agreeing
    scenarios is the shared gradient of those scenarios' loss."""
    C, c = _per_scenario_C_c()
    args = (np.tile(TRUE, (B, 1)), _x_init(2), C, c)
    want_us, want = jax_grads(4, 1e-5, *args)
    _, got_us, got = torch_grads(4, 1e-5, *args)
    agree = np.abs(got_us - want_us).max(axis=(0, 2)) <= 1e-4
    assert agree.mean() >= 0.9, agree.mean()
    for name, g, w, axis in zip(("params", "x_init", "C", "c"), got, want, (0, 0, 1, 1)):
        assert_rows_close(g, w, agree, axis, name)
        shared_g, shared_w = np.compress(agree, g, axis).sum(axis), np.compress(agree, w, axis).sum(axis)
        np.testing.assert_allclose(shared_g, shared_w, rtol=0, atol=1e-3 * np.abs(shared_w).max())


def test_nan_scenario_leaves_the_others_untouched():
    """One scenario's x_init poisoned with NaN: in both packages the other
    scenarios' controls and their x_init gradient rows equal those of the
    clean batch. (The poisoned scenario never improves on its first
    rollout, so its controls stay at the cold start's zeros; its gradient
    row is NaN.)"""
    C, c = _per_scenario_C_c()
    params, x = np.tile(TRUE, (B, 1)), _x_init(3)
    bad = x.copy()
    bad[5] = np.nan
    rest = np.arange(B) != 5
    for solve in (lambda xi: jax_grads(4, 1e-5, params, xi, C, c),
                  lambda xi: torch_grads(4, 1e-5, params, xi, C, c)[1:]):
        us, grads = solve(x)
        us_bad, grads_bad = solve(bad)
        assert (us_bad[:, 5] == 0).all() and np.isnan(grads_bad[1][5]).all()
        np.testing.assert_array_equal(us_bad[:, rest], us[:, rest])
        np.testing.assert_array_equal(grads_bad[1][rest], grads[1][rest])


def test_detach_unconverged_zeroes_the_rows_of_unconverged_scenarios():
    x = _x_init(4)
    C, c = _per_scenario_C_c()
    sol, _, grads = torch_grads(4, 1e-5, TRUE, x, C, c, detach_unconverged=True)
    conv = sol.info.converged.numpy()
    assert 0 < conv.mean() < 1
    assert (grads[1][~conv] == 0).all() and (grads[1][conv] != 0).any()
    _, _, loose = torch_grads(4, 1e-5, TRUE, x, C, c)
    np.testing.assert_array_equal(grads[1][conv], loose[1][conv])


def _expert(config, x_init):
    dx = PendulumDx(params=torch.tensor(TRUE))
    cost = tdm.QuadCost(torch.diag(torch.tensor(Q)), torch.tensor(P))
    _, u_expert, _ = generate_expert_data(config, cost, dx, torch.tensor(x_init), -2.0, 2.0)
    return u_expert


def test_train_steps_match_jax():
    x = _x_init(5)
    config = tdm.MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=1, eps=0.0,
        exit_unconverged=False, detach_unconverged=False,
    )
    u_expert = _expert(config, x)
    params0 = np.array([8.0, 1.25, 0.8], np.float32)

    cost = tdm.QuadCost(torch.diag(torch.tensor(Q)), torch.tensor(P))
    adam = functools.partial(torch.optim.Adam, lr=5e-2)
    step = make_dp_train_step(config, lambda prm: (cost, PendulumDx(params=prm)), adam, None, -2.0, 2.0)
    state = init_train_state(torch.tensor(params0), adam)

    jconfig = jdm.MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=1, eps=0.0,
        exit_unconverged=False, detach_unconverged=False,
        use_pallas=True, pallas_interpret=True,
    )
    jcost = jdm.QuadCost(jnp.diag(jnp.asarray(Q)), jnp.asarray(P))
    opt = optax.adam(5e-2)
    jstep = jax_make_dp_train_step(
        jconfig, lambda prm: (jcost, JaxPendulumDx(params=prm)), opt, None, -2.0, 2.0
    )
    jstate = jax_init_train_state(jnp.asarray(params0), opt)

    for _ in range(3):
        state, stats = step(state, torch.tensor(x), u_expert)
        jstate, jstats = jstep(jstate, jnp.asarray(x), jnp.asarray(u_expert.numpy()))
        np.testing.assert_allclose(state.params.detach().numpy(), np.asarray(jstate.params), atol=5e-4)
        for f in stats._fields:
            np.testing.assert_allclose(float(getattr(stats, f)), float(getattr(jstats, f)), rtol=1e-3, atol=1e-6, err_msg=f)


def test_pendulum_sysid_recovers_params():
    """tests/test_imitation.py's test of the same name, cut from B=64, T=15,
    lqr_iter=8, 40 steps to B=32, T=10, lqr_iter=5, 15 steps: the loss
    falls and at least two of the three params move toward (10, 1, 1)."""
    x = _x_init(40, batch=32)
    config = tdm.MPCConfig(
        n_state=3, n_ctrl=1, T=10, lqr_iter=5, eps=1e-5,
        exit_unconverged=False, detach_unconverged=True,
    )
    dx = PendulumDx(params=torch.tensor(TRUE))
    cost = tdm.QuadCost(torch.diag(torch.tensor(Q)), torch.tensor(P))
    _, u_expert, _ = generate_expert_data(config, cost, dx, torch.tensor(x), -2.0, 2.0)
    params0 = torch.tensor([8.0, 1.25, 0.8])
    adam = functools.partial(torch.optim.Adam, lr=5e-2)
    step = make_dp_train_step(config, lambda prm: (cost, dx.replace(params=prm)), adam, None, -2.0, 2.0)
    state = init_train_state(params0, adam)
    losses = []
    for _ in range(15):
        state, stats = step(state, torch.tensor(x), u_expert)
        losses.append(float(stats.loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.5 * losses[0], losses[::5]
    err0 = (params0 - torch.tensor(TRUE)).abs()
    err1 = (state.params.detach() - torch.tensor(TRUE)).abs()
    assert int((err1 < err0).sum()) >= 2, (err0, err1)
    assert float(stats.converged_frac) > 0.5


def test_data_parallel_options_raise():
    """``params_batch_axes`` and ``task_batch_axes`` on one device: leaves
    other than 0 / None (params) and a non-negative int / None (task) raise;
    per-scenario params ``(B, 3)`` with a per-scenario goal cost vector
    ``(T, B, 4)`` take the step of JAX's ``make_dp_train_step`` (mesh None,
    its XLA path), in float64 at ``lqr_iter=1, eps=0``: loss within rtol 1e-9,
    params within 1e-7."""
    config = tdm.MPCConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=1, eps=0.0,
                           exit_unconverged=False, detach_unconverged=False)
    sgd = functools.partial(torch.optim.SGD, lr=1e-2)
    with pytest.raises(ValueError, match="params_batch_axes"):
        make_dp_train_step(config, lambda prm: None, sgd, params_batch_axes=True)
    with pytest.raises(ValueError, match="task_batch_axes"):
        make_dp_train_step(config, lambda prm, task: None, sgd, task_batch_axes=-1)

    rng = np.random.default_rng(56)
    x = _x_init(56).astype(np.float64)
    params = TRUE.astype(np.float64) * rng.uniform(0.9, 1.1, (B, 3))
    goal = rng.uniform(-0.4, 0.4, B)
    c = np.ascontiguousarray(np.broadcast_to(
        -np.stack([np.cos(goal), np.sin(goal), 0 * goal, 0 * goal], -1) * Q.astype(np.float64), (T, B, 4)))
    C = np.diag(Q.astype(np.float64))
    u = np.zeros((T, B, 1))

    step = make_dp_train_step(
        config, lambda prm, task: (tdm.QuadCost(torch.tensor(C), task), PendulumDx(params=prm)), sgd, None,
        -2.0, 2.0, params_batch_axes=0, task_batch_axes=1,
    )
    state, stats = step(init_train_state(torch.tensor(params), sgd), torch.tensor(x), torch.tensor(u), torch.tensor(c))
    jconfig = jdm.MPCConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=1, eps=0.0, exit_unconverged=False,
                            detach_unconverged=False, dtype=jnp.float64)
    opt = optax.sgd(1e-2)
    jstep = jax_make_dp_train_step(
        jconfig, lambda prm, task: (jdm.QuadCost(jnp.asarray(C), task), JaxPendulumDx(params=prm)), opt, None,
        -2.0, 2.0, params_batch_axes=0, task_batch_axes=1,
    )
    jstate, jstats = jstep(jax_init_train_state(jnp.asarray(params), opt), *map(jnp.asarray, (x, u, c)))
    assert state.params.shape == (B, 3)
    np.testing.assert_allclose(state.params.detach().numpy(), np.asarray(jstate.params), atol=1e-7, rtol=0)
    np.testing.assert_allclose(float(stats.loss), float(jstats.loss), rtol=1e-9)
    np.testing.assert_allclose(float(stats.grad_norm), float(jstats.grad_norm), rtol=1e-6)
