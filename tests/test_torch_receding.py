"""The receding-horizon loop of the port, against the JAX package, and its
utilities.

- ``receding_step`` from a JAX state carried over by
  ``convert.receding_state_from_jax`` (a warm start and a last control that
  are not zero, the slew penalty on): one iteration (eps=0) against the JAX
  step with its fused kernel in interpret mode, the new state, the applied
  control and the objectives within 1e-4.
- Five steps of a B=8 episode (the slew penalty, a perturbed plant): each
  step's applied controls by the chaos rule of tests/torch_parity.py (within
  5e-3 on >= 90% of the scenarios), the states within 1e-3 on those, and the
  shapes of ``run_receding_horizon``'s returns.
- Port only: tests/test_receding.py:13's stabilization episode (B=8, T=15,
  60 steps) ends upright.
- ``utils.logging`` and ``utils.debug`` against the JAX package's
  (``table_log``'s line, the CSV and JSON-lines files) and
  ``checked_solve`` / ``debug_nans`` on a solve that goes non-finite; the
  example ``diffmpc_tpu_torch.examples.receding_mpc`` with ``--cpu``.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import diffmpc_tpu as jdm  # noqa: E402
import diffmpc_tpu_torch as tdm  # noqa: E402
from diffmpc_tpu.models import PendulumDx as JaxPendulumDx  # noqa: E402
from diffmpc_tpu.receding import RecedingState as JaxState  # noqa: E402
from diffmpc_tpu.receding import receding_step as jax_receding_step  # noqa: E402
from diffmpc_tpu.receding import run_receding_horizon as jax_run  # noqa: E402
from diffmpc_tpu.utils import logging as jax_logging  # noqa: E402
from diffmpc_tpu_torch import convert  # noqa: E402
from diffmpc_tpu_torch.models import PendulumDx  # noqa: E402
from diffmpc_tpu_torch.receding import RecedingState, receding_init, receding_step, run_receding_horizon  # noqa: E402
from diffmpc_tpu_torch.utils import logging as port_logging  # noqa: E402
from diffmpc_tpu_torch.utils.debug import checked_solve, debug_nans  # noqa: E402

B, T = 8, 6
PLANT = np.array([10.0, 1.0, 1.0]) * np.array([1.1, 0.9, 1.05])


def _start(seed=640):
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, B)
    return np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, B)], -1).astype(np.float32)


def _jax_config(lqr_iter, eps):
    return jdm.MPCConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=lqr_iter, eps=eps, exit_unconverged=False,
                         detach_unconverged=False, backprop=False, use_pallas=True, pallas_interpret=True,
                         slew_rate_penalty=1.0, not_improved_lim=10**6 if eps == 0 else 5)


def _jax_problem():
    dx = JaxPendulumDx.default(jnp.float32)
    q, p = dx.get_true_obj()
    return jdm.QuadCost(jnp.diag(q), p), dx


def _port_problem():
    dx = PendulumDx.default(device="cpu")
    q, p = dx.get_true_obj()
    return tdm.QuadCost(torch.diag(q), p), dx


@jax.jit
def _jax_step(x, u_warm, prev_u):
    cost, dx = _jax_problem()
    plant = dx.replace(params=jnp.asarray(PLANT, jnp.float32))
    state, (u0, sol) = jax_receding_step(_jax_config(1, 0.0), JaxState(x, u_warm, prev_u), cost, dx,
                                         env_step=plant.forward, u_lower=-2.0, u_upper=2.0)
    return state, u0, sol.objs


@jax.jit
def _jax_episode(x0):
    cost, dx = _jax_problem()
    plant = dx.replace(params=jnp.asarray(PLANT, jnp.float32))
    return jax_run(_jax_config(4, 1e-5), x0, cost, dx, 5, env_step=plant.forward, u_lower=-2.0, u_upper=2.0)


def test_receding_step_matches_jax():
    rng = np.random.default_rng(641)
    jstate = JaxState(jnp.asarray(_start()), jnp.asarray(rng.uniform(-2, 2, (T, B, 1)), jnp.float32),
                      jnp.asarray(rng.uniform(-1, 1, (B, 1)), jnp.float32))
    want, u0_want, objs_want = _jax_step(*jstate)
    state = convert.receding_state_from_jax(jstate, device="cpu")
    assert isinstance(state, RecedingState) and torch.equal(state.x, torch.tensor(np.asarray(jstate.x)))
    cost, dx = _port_problem()
    plant = dx.replace(params=torch.tensor(PLANT, dtype=torch.float32))
    config = convert.mpc_config_from_jax(_jax_config(1, 0.0))
    got, (u0, sol) = receding_step(config, state, cost, dx, env_step=plant.forward, u_lower=-2.0, u_upper=2.0)
    for name, a, b in zip(("x", "u_warm", "prev_u"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, err_msg=name)
    assert torch.equal(got.prev_u, u0) and torch.equal(got.u_warm[-1], got.u_warm[-2])
    np.testing.assert_allclose(u0.numpy(), np.asarray(u0_want), atol=1e-4)
    np.testing.assert_allclose(sol.objs.numpy(), np.asarray(objs_want), atol=1e-4, rtol=1e-5)


def test_five_step_episode_matches_jax():
    xs_want, us_want, objs_want = (np.asarray(a) for a in _jax_episode(jnp.asarray(_start(642))))
    cost, dx = _port_problem()
    plant = dx.replace(params=torch.tensor(PLANT, dtype=torch.float32))
    config = convert.mpc_config_from_jax(_jax_config(4, 1e-5))
    xs, us, objs = run_receding_horizon(config, torch.tensor(_start(642)), cost, dx, 5, env_step=plant.forward,
                                        u_lower=-2.0, u_upper=2.0)
    assert xs.shape == (6, B, 3) and us.shape == (5, B, 1) and objs.shape == (5, B)
    assert xs_want.shape == tuple(xs.shape) and us_want.shape == tuple(us.shape)
    for step in range(5):
        close = np.abs(us[step].numpy() - us_want[step]).max(-1) <= 5e-3
        assert close.mean() >= 0.9, (step, us[step].numpy().ravel(), us_want[step].ravel())
    keep = (np.abs(us.numpy() - us_want) <= 5e-3).all(axis=(0, 2))
    np.testing.assert_allclose(xs.numpy()[:, keep], xs_want[:, keep], atol=1e-3)
    np.testing.assert_allclose(objs.numpy()[:, keep], objs_want[:, keep], rtol=1e-3, atol=1e-3)


def test_receding_horizon_stabilizes_pendulum():
    """tests/test_receding.py:13 on the port: every scenario ends close to
    upright (cos > 0.95, |speed| < 0.5, averaged over the last ten steps),
    the controls inside the box."""
    dx = PendulumDx.default(device="cpu")
    q, p = dx.get_true_obj()
    config = tdm.MPCConfig(n_state=3, n_ctrl=1, T=15, lqr_iter=6, eps=1e-5, exit_unconverged=False,
                           detach_unconverged=False)
    rng = np.random.default_rng(60)
    th = rng.uniform(-0.8, 0.8, 8)
    x0 = torch.tensor(np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, 8)], -1), dtype=torch.float32)
    assert receding_init(config, x0).u_warm.shape == (15, 8, 1)
    xs, us, _ = run_receding_horizon(config, x0, tdm.QuadCost(torch.diag(q), p), dx, 60, u_lower=-2.0, u_upper=2.0)
    assert xs.shape == (61, 8, 3) and us.shape == (60, 8, 1)
    assert bool((us.abs() <= 2.0 + 1e-6).all())
    tail = xs[-10:].mean(0)
    assert bool((tail[:, 0] > 0.95).all()), tail
    assert bool((tail[:, 2].abs() < 0.5).all()), tail


def test_logging_matches_jax(tmp_path, capsys):
    values = (("iter", 3), ("obj", 0.125, "{:.3e}"), ("frac", 0.5, "{:.2f}"))
    assert port_logging.table_log("lqr", values) == jax_logging.table_log("lqr", values)
    for mod, name in ((jax_logging, "jax"), (port_logging, "port")):
        csv = mod.CSVLogger(str(tmp_path / name / "m.csv"), ["step", "loss"])
        csv.log(step=0, loss=1.5)
        csv.log(step=1)
        csv.close()
        jl = mod.JSONLLogger(str(tmp_path / name / "m.jsonl"))
        jl.log(step=0, loss=1.5, time=1.0)
        jl.close()
    assert (tmp_path / "jax" / "m.csv").read_text() == (tmp_path / "port" / "m.csv").read_text()
    assert json.loads((tmp_path / "port" / "m.jsonl").read_text()) == {"step": 0, "loss": 1.5, "time": 1.0}
    with port_logging.profile_trace(None) as prof:
        assert prof is None
    with port_logging.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(3).sum()
    assert prof is not None and any((tmp_path / "trace").iterdir())


def test_checked_solve_and_debug_nans():
    cost, dx = _port_problem()
    config = tdm.MPCConfig(n_state=3, n_ctrl=1, T=4, lqr_iter=2, exit_unconverged=False)
    checked = checked_solve(lambda x: tdm.mpc_solve(config, x, cost, dx, u_lower=-2.0, u_upper=2.0))
    check, sol = checked(torch.tensor(_start()))
    assert check.get() is None and sol.us.shape == (4, B, 1)
    check.throw()
    bad = torch.tensor(_start())
    bad[3, 2] = float("nan")
    check, _ = checked(bad)
    assert "non-finite" in check.get()
    with pytest.raises(RuntimeError, match="non-finite value in solve output"):
        check.throw()
    before = torch.is_anomaly_enabled()
    with debug_nans():
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1.0).sum().backward()
    assert torch.is_anomaly_enabled() == before


def test_receding_example_runs_on_the_cpu(tmp_path, capsys):
    from diffmpc_tpu_torch.examples import receding_mpc

    out = tmp_path / "log.csv"
    frac = receding_mpc.main(["--cpu", "--batch", "4", "--horizon", "5", "--env-steps", "2", "--lqr-iter", "2",
                              "--slew", "1.0", "--plant-param-error", "0.15", "--out", str(out)])
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[receding_mpc]")]
    assert len(line) == 1 and "success_frac=" in line[0] and "ms_per_env_step=" in line[0]
    assert 0.0 <= frac <= 1.0 and len(out.read_text().splitlines()) == 3
