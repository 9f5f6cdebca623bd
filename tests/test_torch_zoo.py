"""The dynamics zoo on the port (CartpoleDx, VehicleDx, QuadrotorDx,
AcrobotDx) against the JAX package's envs, on the CPU.

- ``forward``, ``entries_step`` and ``grad_input`` (the protocol's jacfwd)
  against the JAX env in float64 on numpy-seeded inputs, with shared and
  per-scenario ``(B, P)`` params: within 1e-10; in float32, ``grad_input``
  stays float32.
- The converters: a JAX env with other constants than its defaults through
  ``convert.<env>_from_jax`` computes the same ``forward`` and carries every
  field.
- Each C++ step's struct (``csrc/<env>.cuh``) against its ctypes mirror and
  its ``kCheapStep`` against the registry's (``ops/cuda/ilqr.py``).
- The cartpole's plain fused solve within 1e-4 of the JAX package's Pallas
  kernel in interpret mode after one iteration (B=8, T=10; the goldens,
  ``tests/test_torch_golden_f64.py``, hold the four envs over fifteen).
- BASELINE.json config 4's imitation step at a small size (B=16, T=10,
  ``lqr_iter=3``, float64): the port's ``make_dp_train_step`` against JAX's
  without a mesh, the loss within 1e-5 relative; the ``dyn`` and ``logq``
  gradients of the loss over the scenarios that reach the same fixed point
  in both packages within 1e-3 of their max-abs. As in the other step
  comparisons (tests/torch_dist_cases.py, the recipe of
  tests/test_sharding.py:22-45), ``eps=0`` and ``not_improved_lim=10**6``:
  on the CPU the JAX package solves by its XLA loop and the port by its
  fused solve, and with ``eps > 0`` the two paths of either package part on
  a scenario frozen early (the XLA loop, like the port's non-fused loop,
  still takes a later improving step into its best trajectory; the fused
  solve keeps the frozen one: 4.9e-5 apart on the controls, 2e-11 on the
  objective, at this size).
"""

import dataclasses
import functools
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import diffmpc_tpu as jdm  # noqa: E402
import diffmpc_tpu_torch as tdm  # noqa: E402
from diffmpc_tpu.models import envs as jax_envs  # noqa: E402
from diffmpc_tpu.ops.pallas.ilqr import ilqr_solve_fused as jax_ilqr  # noqa: E402
from diffmpc_tpu.parallel import generate_expert_data as jax_expert  # noqa: E402
from diffmpc_tpu.parallel import init_train_state as jax_init_train_state  # noqa: E402
from diffmpc_tpu.parallel import make_dp_train_step as jax_make_dp_train_step  # noqa: E402
from diffmpc_tpu_torch import convert  # noqa: E402
from diffmpc_tpu_torch.csrc import build  # noqa: E402
from diffmpc_tpu_torch.ops.cuda import ilqr as il  # noqa: E402
from diffmpc_tpu_torch.parallel import generate_expert_data, init_train_state, make_dp_train_step  # noqa: E402
from torch_parity import as_numpy, assert_tight  # noqa: E402
from torch_zoo_cases import ZOO, golden_case, kernel_problem, port_model  # noqa: E402

jax.config.update("jax_enable_x64", True)

CONVERTERS = {"cartpole": convert.cartpole_from_jax, "vehicle": convert.vehicle_from_jax,
              "quadrotor": convert.quadrotor_from_jax, "acrobot": convert.acrobot_from_jax}


# The JAX envs' functions, each compiled whole (the model an argument): run
# eagerly, JAX compiles each primitive at each new shape, which took most of
# this file's time.
_jax_forward = jax.jit(lambda dx, x, u: dx.forward(x, u))
_jax_entries_step = jax.jit(lambda dx, p, x, u: dx.entries_step(p, x, u))
_jax_grad_input = jax.jit(lambda dx, x, u: dx.grad_input(x, u))


def jax_model(name: str, params=None):
    dx = getattr(jax_envs, f"{name.capitalize()}Dx").default(jnp.float64)
    return dx if params is None else dx.replace(params=jnp.asarray(params))


def _inputs(name: str, B: int, seed: int):
    """States near the env's working point, controls across its box and
    past it (the clamps), and per-scenario params 0.7-1.3 of the true."""
    x, n, m, _, (lo, hi) = golden_case(name, B)
    rng = np.random.default_rng(seed)
    x = x + 0.1 * rng.standard_normal(x.shape)
    lo, hi = np.broadcast_to(lo, (m,)), np.broadcast_to(hi, (m,))
    u = rng.uniform(lo - 0.2 * (hi - lo), hi + 0.2 * (hi - lo), (B, m))
    params = np.asarray(jax_model(name).params) * rng.uniform(0.7, 1.3, (B, jax_model(name).params.shape[-1]))
    return x, u, params


@pytest.mark.parametrize("per_scenario", [False, True], ids=["shared", "per_scenario"])
@pytest.mark.parametrize("name", ZOO)
def test_env_matches_jax_in_float64(name, per_scenario):
    B = 9
    x, u, params = _inputs(name, B, seed=1300 + ZOO.index(name))
    jdx = jax_model(name, params if per_scenario else None)
    tdx = port_model(name, torch.float64, params if per_scenario else None)
    tol = dict(atol=1e-10, rtol=0)
    jx, ju, tx, tu = jnp.asarray(x), jnp.asarray(u), torch.tensor(x), torch.tensor(u)
    np.testing.assert_allclose(tdx.forward(tx, tu).numpy(), np.asarray(_jax_forward(jdx, jx, ju)), **tol)
    # entries_step on (B,) entries, params as a list of scalars or (B,) rows
    prm_j = list(jnp.asarray(params).T) if per_scenario else list(jdx.params)
    prm_t = list(torch.tensor(params).T) if per_scenario else list(tdx.params)
    got = tdx.entries_step(prm_t, list(tx.T), list(tu.T))
    want = _jax_entries_step(jdx, prm_j, list(jx.T), list(ju.T))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    # grad_input: the protocol's forward-mode autodiff, jointly over the
    # scenario's params when they are per-scenario
    (A, Bm), (jA, jB) = tdx.grad_input(tx, tu), _jax_grad_input(jdx, jx, ju)
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), **tol)
    np.testing.assert_allclose(Bm.numpy(), np.asarray(jB), **tol)
    # over time too: (T, B, n)
    xt, ut = np.stack([x, x[::-1]]), np.stack([u, u[::-1]])
    (A, _), (jA, _) = tdx.grad_input(torch.tensor(xt), torch.tensor(ut)), _jax_grad_input(jdx, jnp.asarray(xt),
                                                                                        jnp.asarray(ut))
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), **tol)
    if not per_scenario:
        for a, b in zip(tdx.get_true_obj(), jdx.get_true_obj(), strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize("per_scenario", [False, True], ids=["shared", "per_scenario"])
@pytest.mark.parametrize("name", ZOO)
def test_jacobians_keep_the_models_dtype(name, per_scenario):
    """``grad_input`` of a float32 model is float32, as the JAX package's
    is (under ``jacfwd`` a Python float in a sum promoted the tangents to
    float64, and the attach then handed the KKT backward a float64 F), and
    within float32 rounding of the JAX package's float32 Jacobians."""
    x, u, params = _inputs(name, 6, seed=1320)
    jdx = getattr(jax_envs, f"{name.capitalize()}Dx").default(jnp.float32)
    prm = params.astype(np.float32) if per_scenario else None
    if per_scenario:
        jdx = jdx.replace(params=jnp.asarray(prm))
    tdx = port_model(name, torch.float32, prm)
    x32, u32 = x.astype(np.float32), u.astype(np.float32)
    got = tdx.grad_input(torch.tensor(x32), torch.tensor(u32))
    want = _jax_grad_input(jdx, jnp.asarray(x32), jnp.asarray(u32))
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5 * np.abs(np.asarray(w)).max())


# each env with constants other than its defaults
OTHER_FIELDS = {"cartpole": dict(dt=0.03, max_force=40.0, clamp_ctrl=True),
                "vehicle": dict(max_accel=2.0, max_brake=5.0, max_steer=0.4, max_speed=12.0, v_ref=4.0, dt=0.04,
                                clamp_ctrl=False),
                "quadrotor": dict(max_thrust=4.0, dt=0.02, clamp_ctrl=False),
                "acrobot": dict(max_torque=3.0, max_speed1=10.0, max_speed2=20.0, dt=0.02, clamp_ctrl=False)}


@pytest.mark.parametrize("name", ZOO)
def test_converter_carries_every_field(name):
    _, u, params = _inputs(name, 5, seed=1310)
    jdx = jax_model(name, params).replace(**OTHER_FIELDS[name])
    tdx = CONVERTERS[name](jdx, device="cpu")
    for f in dataclasses.fields(tdx):
        if f.name != "params":
            assert getattr(tdx, f.name) == getattr(jdx, f.name), f.name
    np.testing.assert_array_equal(tdx.params.numpy(), np.asarray(jdx.params))
    x = golden_case(name, 5)[0]
    np.testing.assert_allclose(tdx.forward(torch.tensor(x), torch.tensor(u)).numpy(),
                               np.asarray(_jax_forward(jdx, jnp.asarray(x), jnp.asarray(u))), atol=1e-10, rtol=0)
    assert CONVERTERS[name](jdx, torch.float32, "cpu").params.dtype == torch.float32


def test_cpp_steps_match_their_mirrors():
    """Each C++ env's struct fields, in order, are its ctypes mirror's; its
    ``N``, ``M``, ``P`` and ``kCheapStep`` are the registry's; and every
    field is the model's attribute of the same name."""
    for cls, (struct, name, n_params, _) in il._CPP_ENVS.items():
        with open(os.path.join(build.CSRC, f"{name}.cuh")) as f:
            text = f.read()
        body = re.search(rf"struct {name.capitalize()}Env \{{(.*?)\n\}};", text, re.S).group(1)
        fields = re.findall(r"^  (float|int) (\w+);", body, re.M)
        assert [f for _, f in fields] == [f for f, _ in struct._fields_], name
        ctype = {"float": "c_float", "int": "c_int"}
        assert [ctype[t] for t, _ in fields] == [c.__name__ for _, c in struct._fields_], name
        consts = dict(re.findall(r"static constexpr (?:int|bool) (\w+) = (\w+);", body))
        assert (int(consts["N"]), int(consts["M"]), int(consts["P"])) == (cls.n_state, cls.n_ctrl, n_params), name
        dx = cls.default(device="cpu")
        assert all(hasattr(dx, f) for f, _ in struct._fields_)
        env = il.kernel_env(dx)
        assert consts["kCheapStep"] == ("true" if env.cheap_step else "false"), name
        assert (env.n, env.m, env.n_params, env.kind) == (cls.n_state, cls.n_ctrl, n_params, name)


def test_cartpole_plain_fused_solve_matches_the_jax_kernel_in_interpret_mode():
    """One iteration of the fused solve (B=8, T=10) in float32: the port's
    plain version within 1e-4 of the JAX package's Pallas kernel run in
    interpret mode, ``n_iters`` equal."""
    B, T = 8, 10
    args = kernel_problem("cartpole", B, T, torch.float32)
    knobs = dict(lqr_iter=1, eps=0.0)
    plain = as_numpy(il.ilqr_solve_plain(*args, **knobs))
    x0, C, c, _, lo, hi = (jnp.asarray(a.numpy()) if torch.is_tensor(a) else a for a in args)
    out = jax_ilqr(x0, C, c, jax_envs.CartpoleDx.default(jnp.float32), lo, hi, interpret=True, **knobs)
    assert_tight(plain, {f: np.asarray(getattr(out, f)) for f in out._fields})


# BASELINE.json config 4 (examples/il_cartpole.py:52-99) at a small size
IL_B, IL_T, IL_ITER, IL_BOX, IL_LR = 16, 10, 3, 10.0, 2e-2
GOAL = [0.0, 0.0, 1.0, 0.0, 0.0, 0.0]


def _il_start():
    x = golden_case("cartpole", IL_B)[0]
    rng = np.random.default_rng(1)
    true = np.asarray(jax_model("cartpole").params)
    q = np.asarray(jax_model("cartpole").get_true_obj()[0])
    return x, dict(dyn=true * rng.uniform(0.75, 1.25, 4), logq=np.log(q) + rng.uniform(-0.5, 0.5, 6))


@functools.lru_cache(maxsize=None)
def _jax_config4():
    """The JAX step of config 4 and the scenarios' controls, at the
    learner's first params: the step's stats and new params, the solve's
    controls and converged flags, and the gradient of a masked loss."""
    x, prm0 = _il_start()
    config = jdm.MPCConfig(n_state=5, n_ctrl=1, T=IL_T, lqr_iter=IL_ITER, eps=1e-5, exit_unconverged=False,
                           detach_unconverged=True, dtype=jnp.float64)
    true_dx = jax_model("cartpole")
    q, p = true_dx.get_true_obj()
    cost = jdm.QuadCost(jnp.diag(q), p)

    @jax.jit
    def expert(x0):
        _, u, _ = jax_expert(config, cost, true_dx, x0, -IL_BOX, IL_BOX)
        return u, jdm.mpc_solve(config, x0, cost, true_dx, u_lower=-IL_BOX, u_upper=IL_BOX).info.converged

    u_expert, converged_expert = expert(jnp.asarray(x))

    def make_problem(prm):
        qq = jnp.exp(prm["logq"])
        return jdm.QuadCost(jnp.diag(qq), -qq * jnp.asarray(GOAL)), true_dx.replace(params=prm["dyn"])

    opt = optax.adam(IL_LR)
    step = jax_make_dp_train_step(config, make_problem, opt, None, u_lower=-IL_BOX, u_upper=IL_BOX)
    params = {k: jnp.asarray(v) for k, v in prm0.items()}
    state, stats = step(jax_init_train_state(params, opt), jnp.asarray(x), u_expert)

    def masked_loss(prm, keep):
        cost, dx = make_problem(prm)
        sol = jdm.mpc_solve(config, jnp.asarray(x), cost, dx, u_lower=-IL_BOX, u_upper=IL_BOX)
        per = jnp.mean((sol.us - u_expert) ** 2, axis=(0, 2))
        return jnp.sum(per * keep) / jnp.sum(keep), sol

    value_and_grad = jax.jit(jax.value_and_grad(masked_loss, has_aux=True))  # compiled once, for any mask
    (_, sol), _ = value_and_grad(params, jnp.ones(IL_B))
    return dict(stats={k: float(v) for k, v in stats._asdict().items()},
                params={k: np.asarray(v) for k, v in state.params.items()}, u_expert=np.asarray(u_expert),
                us=np.asarray(sol.us), converged=np.asarray(sol.info.converged),
                converged_expert=np.asarray(converged_expert),
                grad=lambda keep: {k: np.asarray(v) for k, v in value_and_grad(params, jnp.asarray(keep))[1].items()})


def test_config4_step_matches_jax():
    """The port's imitation step of config 4 against the JAX package's, no
    mesh, float64: the loss within 1e-5 relative, the converged share
    equal; each learned leaf's gradient of
    the loss over the scenarios whose controls reach the same fixed point
    in both packages within 1e-3 of its max-abs; the gradient norm within
    1e-5 relative; Adam's first step moves each param the same way (1e-6).
    The expert's controls are the JAX package's in both steps; the port's
    own equal them on the scenarios that no iteration froze early."""
    x, prm0 = _il_start()
    want = _jax_config4()
    config = tdm.MPCConfig(n_state=5, n_ctrl=1, T=IL_T, lqr_iter=IL_ITER, eps=1e-5, exit_unconverged=False,
                           detach_unconverged=True)
    true_dx = port_model("cartpole", torch.float64)
    q, p = true_dx.get_true_obj()
    x = torch.tensor(x)
    _, u_expert, _ = generate_expert_data(config, tdm.QuadCost(torch.diag(q), p), true_dx, x, -IL_BOX, IL_BOX)
    never_froze = ~want["converged_expert"]
    assert never_froze.sum() >= 4
    np.testing.assert_allclose(u_expert.numpy()[:, never_froze], want["u_expert"][:, never_froze], atol=1e-7, rtol=0)
    u_expert = torch.tensor(want["u_expert"])
    goal = torch.tensor(GOAL, dtype=torch.float64)

    def make_problem(prm):
        qq = torch.exp(prm["logq"])
        return tdm.QuadCost(torch.diag_embed(qq), -qq * goal), true_dx.replace(params=prm["dyn"])

    opt = functools.partial(torch.optim.Adam, lr=IL_LR)
    step = make_dp_train_step(config, make_problem, opt, u_lower=-IL_BOX, u_upper=IL_BOX)
    params = {k: torch.tensor(v) for k, v in prm0.items()}
    state, stats = step(init_train_state(params, opt), x, u_expert)
    np.testing.assert_allclose(float(stats.loss), want["stats"]["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(stats.grad_norm), want["stats"]["grad_norm"], rtol=1e-5)
    assert float(stats.converged_frac) == want["stats"]["converged_frac"]
    # the scenarios at the same fixed point in both packages
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    cost, dx = make_problem(leaves)
    sol = tdm.mpc_solve(config, x, cost, dx, u_lower=-IL_BOX, u_upper=IL_BOX)
    same = (np.abs(sol.us.detach().numpy() - want["us"]).max(axis=(0, 2)) <= 1e-6) \
        & (sol.info.converged.numpy() == want["converged"])
    assert same.mean() >= 0.5, same  # the others froze early, where the two paths part (module docstring)
    keep = torch.tensor(same, dtype=torch.float64)
    per = torch.mean((sol.us - u_expert) ** 2, dim=(0, 2))
    grads = torch.autograd.grad((per * keep).sum() / keep.sum(), list(leaves.values()))
    jgrad = want["grad"](same.astype(np.float64))
    for k, g in zip(leaves, grads):
        w = jgrad[k]
        assert np.abs(g.numpy() - w).max() <= 1e-3 * np.abs(w).max(), (k, g, w)
    for k in params:
        np.testing.assert_allclose(state.params[k].detach().numpy(), want["params"][k], atol=1e-6, rtol=0)
