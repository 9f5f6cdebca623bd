"""The slew-rate penalty and ``u_zero_I`` in the port, against the JAX package.

- ``CtrlPassthroughDynamics`` (tests/test_dynamics.py:53): forward and the
  composed Jacobians against JAX in float64 and against autodiff; its kernel
  protocol, its kernel env and the variant keys it takes (names, defines).
- The slew penalty on the fused path (tests/test_pallas_ilqr.py:491's
  problem, ``prev_ctrl`` 0.5): the port's plain fused solve against the JAX
  fused kernel in interpret mode, one iteration within 1e-4, four by the
  chaos rule of tests/torch_parity.py, and the gradients of a loss with
  respect to ``x_init``, ``prev_ctrl`` and per-scenario params on the
  scenarios where both sides reach the same fixed point (controls within
  1e-5), within 1e-3 of each gradient's max-abs.
- The slew penalty on the non-fused path (a ``LinDx`` box-DDP in float64,
  the cost shared over the batch): the solve and the gradients with respect
  to every input within 1e-6 of JAX's; the KKT backward reads the augmented
  C in place.
- ``u_zero_I`` (tests/test_mpc_knobs.py:108, :132): the pinned dims exactly
  0, the solve within 1e-6 of JAX's, alone and with the slew penalty; on the
  fused path, the vehicle's steering pinned is the solve with its steering
  box at [0, 0], bit for bit.
- The control-passthrough kernels' host build: g++ builds the fused solve
  and the line search (``csrc/ilqr.cuh``, ``csrc/rollout.cuh``) with the
  pendulum's, the vehicle's and a 3-8-3 MLP's step wrapped by
  ``CtrlPassthroughEnv`` (``csrc/passthrough.cuh``) from the macros that
  the card's variants are built from (``csrc/build.py::variant_defines``),
  and holds them against the plain versions (one iteration within 1e-4,
  the line search within 1e-5 relative) with every built lane count
  bit-equal to one lane.
"""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import diffmpc_tpu as jdm  # noqa: E402
import diffmpc_tpu_torch as tdm  # noqa: E402
from diffmpc_tpu.models import NNDynamics as JaxNN  # noqa: E402
from diffmpc_tpu.models import PendulumDx as JaxPendulumDx  # noqa: E402
from diffmpc_tpu.models.dynamics import CtrlPassthroughDynamics as JaxPassthrough  # noqa: E402
from diffmpc_tpu_torch import convert  # noqa: E402
from diffmpc_tpu_torch.csrc import build  # noqa: E402
from diffmpc_tpu_torch.models import CtrlPassthroughDynamics, NNDynamics, PendulumDx, VehicleDx  # noqa: E402
from diffmpc_tpu_torch.models.dynamics import autodiff_grad_input  # noqa: E402
from diffmpc_tpu_torch.ops.cuda import ilqr as ilqr_mod  # noqa: E402
from diffmpc_tpu_torch.ops.cuda import kkt as kkt_mod  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.ilqr import ILQR_LANES, _IlqrArgs, ilqr_solve_plain, run_staged  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.riccati import riccati_backward_plain  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.rollout import (  # noqa: E402
    ROLLOUT_LANES,
    _RolloutArgs,
    linesearch_rollout_plain,
    run_staged_rollout,
)
from diffmpc_tpu_torch.ops.linearize import linearize_dynamics  # noqa: E402
from diffmpc_tpu_torch.utils.batch import bmv  # noqa: E402
from oracles import random_lqr_problem  # noqa: E402
from torch_parity import as_numpy, assert_chaos, assert_tight  # noqa: E402

# ---------------------------------------------------------------------------
# CtrlPassthroughDynamics
# ---------------------------------------------------------------------------


def test_ctrl_passthrough_composition_matches_jax():
    """tests/test_dynamics.py:53's wrapper of a 3-8-3 MLP (n=3, m=2) in
    float64: forward and the composed ``grad_input`` equal JAX's and the
    port's autodiff of forward."""
    n, m, B = 3, 2, 4
    jinner = JaxNN.init(jax.random.PRNGKey(4), n, m, hidden=(8,), dtype=jnp.float64)
    jwrap = JaxPassthrough(inner=jinner, n_ctrl=m)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (B, m + n), jnp.float64))
    u = np.asarray(jax.random.normal(jax.random.PRNGKey(6), (B, m), jnp.float64))
    wrap = convert.ctrl_passthrough_from_jax(jwrap, device="cpu")
    assert isinstance(wrap, CtrlPassthroughDynamics) and wrap.n_ctrl == m
    xt, ut = torch.tensor(x), torch.tensor(u)
    out = wrap.forward(xt, ut)
    np.testing.assert_allclose(out[:, :m].numpy(), u)
    np.testing.assert_allclose(out.numpy(), np.asarray(jwrap.forward(jnp.asarray(x), jnp.asarray(u))), atol=1e-12)
    A, Bm = wrap.grad_input(xt, ut)
    Aj, Bj = jwrap.grad_input(jnp.asarray(x), jnp.asarray(u))
    np.testing.assert_allclose(A.numpy(), np.asarray(Aj), atol=1e-12)
    np.testing.assert_allclose(Bm.numpy(), np.asarray(Bj), atol=1e-12)
    Aa, Ba = autodiff_grad_input(wrap.forward, xt, ut)
    np.testing.assert_allclose(A.numpy(), Aa.numpy(), atol=1e-10)
    np.testing.assert_allclose(Bm.numpy(), Ba.numpy(), atol=1e-10)


@pytest.mark.parametrize("per_scenario", [False, True])
def test_ctrl_passthrough_kernel_protocol(per_scenario):
    """The wrapper is fusable where its inner model is, its kernel params
    are the inner model's, its ``entries_step`` equals its forward entry by
    entry, its tensors, dtype and device are the inner model's, and the
    kernels see the inner env at the wrapped shape."""
    B = 6
    inner = PendulumDx.default(torch.float64, device="cpu")
    if per_scenario:
        spread = torch.tensor(np.random.default_rng(1).uniform(0.9, 1.1, (B, 3)))
        inner = inner.replace(params=inner.params * spread)
    wrap = CtrlPassthroughDynamics(inner=inner, n_ctrl=1)
    assert wrap.kernel_fusable and torch.equal(wrap.kernel_params(), inner.kernel_params())
    assert wrap.tensors() == inner.tensors()
    assert wrap.to(torch.float32).kernel_params().dtype == torch.float32
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((B, 4)))
    u = torch.tensor(rng.standard_normal((B, 1)))
    prm = inner.kernel_params()
    prm = list(prm.t()) if prm.ndim == 2 else list(prm)
    ent = wrap.entries_step(prm, list(x.t()), list(u.t()))
    np.testing.assert_allclose(torch.stack(ent, -1).numpy(), wrap.forward(x, u).numpy(), atol=1e-12)
    env = ilqr_mod.kernel_env(wrap)
    inner_env = ilqr_mod.kernel_env(inner)
    assert (env.n, env.m, env.passthrough, env.symbol) == (4, 1, True, None)
    assert type(env.struct) is type(inner_env.struct)
    assert (env.n_params, env.per_scenario, env.cheap_step, env.kind) == (3, True, True, "pendulum")
    with pytest.raises(ValueError, match="wraps"):
        ilqr_mod.kernel_env(CtrlPassthroughDynamics(inner=wrap, n_ctrl=1))


def test_passthrough_variant_keys_name_and_define_the_wrap():
    """Each passthrough model resolves to a variant of its own, named with
    ``_p1`` and built with ``-DDMPC_PASSTHROUGH=1`` at the wrapped shape;
    the other keys keep their names and defines."""
    pend = CtrlPassthroughDynamics(inner=PendulumDx.default(device="cpu"), n_ctrl=1)
    veh = CtrlPassthroughDynamics(inner=VehicleDx.default(device="cpu"), n_ctrl=2)
    mlp = CtrlPassthroughDynamics(inner=NNDynamics.init(3, 2, hidden=(8,), device="cpu"), n_ctrl=2)
    want = {
        (pend, "ilqr"): ("ilqr_n4m1_pendulum_e0_x0_p1", ["-DDMPC_ENV=PendulumEnv", '-DDMPC_ENV_HEADER="pendulum.cuh"']),
        (veh, "rollout"): ("rollout_n6m2_vehicle_e0_x0_p1", ["-DDMPC_ENV=VehicleEnv", '-DDMPC_ENV_HEADER="vehicle.cuh"']),
        (mlp, "ilqr"): ("ilqr_n5m2_nn_h8_e0_x0_p1", ['-DDMPC_HIDDEN="8"']),
    }
    for (dyn, family), (name, env_defs) in want.items():
        key = ilqr_mod.env_variant_key(ilqr_mod.kernel_env(dyn), family)
        assert key.passthrough and key.name == name
        n, m = key.n, key.m
        assert build.variant_defines(key) == [f"-DDMPC_N={n}", f"-DDMPC_M={m}", "-DDMPC_ENUM=0", "-DDMPC_EXACT=0",
                                              *env_defs, "-DDMPC_PASSTHROUGH=1"]
        assert build.variant_path(key) != build.variant_path(key._replace(passthrough=False))
    plain = ilqr_mod.env_variant_key(ilqr_mod.kernel_env(VehicleDx.default(device="cpu")), "ilqr")
    assert plain.name == "ilqr_n4m2_vehicle_e0_x0" and "-DDMPC_PASSTHROUGH=1" not in build.variant_defines(plain)
    for bad in (build.VariantKey("riccati", 4, 1, passthrough=True), build.VariantKey("ilqr", 4, 1, passthrough=True)):
        with pytest.raises(ValueError, match="passthrough"):
            build.variant_defines(bad)


# ---------------------------------------------------------------------------
# The slew penalty on the fused path (the pendulum)
# ---------------------------------------------------------------------------

SLEW_B, SLEW_T = 48, 5


def _pendulum_slew_problem(B=SLEW_B, T=SLEW_T):
    """tests/test_pallas_ilqr.py:491's problem (its _pendulum_problem,
    prev_ctrl 0.5, slew 0.5) as numpy float32, with per-scenario params
    0.9-1.1 of the true ones."""
    rng = np.random.default_rng(700)
    th = rng.uniform(-np.pi, np.pi, B)
    x = np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, B)], -1).astype(np.float32)
    params = (np.array([10.0, 1.0, 1.0]) * np.random.default_rng(701).uniform(0.9, 1.1, (B, 3))).astype(np.float32)
    return x, np.full((B, 1), 0.5, np.float32), params


def _jax_slew_config(lqr_iter, eps):
    return jdm.MPCConfig(n_state=3, n_ctrl=1, T=SLEW_T, lqr_iter=lqr_iter, eps=eps, not_improved_lim=10**6 if eps == 0
                         else 5, exit_unconverged=False, detach_unconverged=False, use_pallas=True,
                         pallas_interpret=True, slew_rate_penalty=0.5)


def _jax_slew_solve_and_grads(lqr_iter, eps):
    config = _jax_slew_config(lqr_iter, eps)
    base = JaxPendulumDx.default(jnp.float32)
    q, p = base.get_true_obj()
    cost = jdm.QuadCost(jnp.diag(q), p)

    def loss(x, prev, params):
        sol = jdm.mpc_solve(config, x, cost, base.replace(params=params), u_lower=-2.0, u_upper=2.0, prev_ctrl=prev)
        return jnp.sum(sol.us ** 2) + jnp.sum(sol.xs[..., 2] ** 2), sol

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))


_JAX_SLEW = {k: _jax_slew_solve_and_grads(*k) for k in ((1, 0.0), (4, 1e-5))}


def _port_slew(lqr_iter, eps, grads=False):
    x, prev, params = _pendulum_slew_problem()
    config = convert.mpc_config_from_jax(_jax_slew_config(lqr_iter, eps))
    dx = PendulumDx.default(device="cpu")
    q, p = dx.get_true_obj()
    leaves = [torch.tensor(a, requires_grad=grads) for a in (x, prev, params)]
    sol = tdm.mpc_solve(config, leaves[0], tdm.QuadCost(torch.diag(q), p), dx.replace(params=leaves[2]),
                        u_lower=-2.0, u_upper=2.0, prev_ctrl=leaves[1])
    if not grads:
        return sol, None
    loss = (sol.us ** 2).sum() + (sol.xs[..., 2] ** 2).sum()
    return sol, torch.autograd.grad(loss, leaves)


def _sol_np(sol):
    arr = lambda a: a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)  # noqa: E731
    return dict(us=arr(sol.us), objs=arr(sol.objs), converged=arr(sol.info.converged), alpha=arr(sol.info.mean_alpha))


def test_slew_fused_one_iteration_matches_jax(monkeypatch):
    """One iteration (eps=0): the augmented solve launches the fused solve
    once, with the passthrough model at n=4, and its outputs are within
    1e-4 of the JAX fused kernel's; the augmented state is stripped."""
    calls = []
    orig = ilqr_mod.ilqr_solve_fused

    def counting(x_init, C, c, dyn, *args, **kw):
        calls.append((type(dyn).__name__, tuple(x_init.shape), tuple(C.shape)))
        return orig(x_init, C, c, dyn, *args, **kw)

    monkeypatch.setattr(tdm.mpc, "ilqr_solve_fused", counting)
    got, _ = _port_slew(1, 0.0)
    assert calls == [("CtrlPassthroughDynamics", (SLEW_B, 4), (SLEW_T, SLEW_B, 5, 5))]
    x, prev, params = _pendulum_slew_problem()
    (_, want), _ = _JAX_SLEW[(1, 0.0)](jnp.asarray(x), jnp.asarray(prev), jnp.asarray(params))
    assert got.xs.shape == (SLEW_T, SLEW_B, 3) and got.us.shape == (SLEW_T, SLEW_B, 1)
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(want.xs), atol=1e-4)
    np.testing.assert_allclose(got.us.numpy(), np.asarray(want.us), atol=1e-4)
    np.testing.assert_allclose(got.objs.numpy(), np.asarray(want.objs), atol=1e-4, rtol=1e-5)


def test_slew_fused_solve_and_gradients_match_jax():
    """Four iterations by the chaos rule; the gradients with respect to
    x_init, prev_ctrl and the per-scenario params, row by row on the
    scenarios at the same fixed point, within 1e-3 of each max-abs. The
    penalty bites: the first control sits nearer prev_ctrl than without it."""
    got, grads = _port_slew(4, 1e-5, grads=True)
    x, prev, params = _pendulum_slew_problem()
    (_, want), jgrads = _JAX_SLEW[(4, 1e-5)](jnp.asarray(x), jnp.asarray(prev), jnp.asarray(params))
    g, w = _sol_np(got), _sol_np(want)
    ones = np.ones(SLEW_B, np.int32)
    assert_chaos(dict(g, n_iters=g["converged"] * ones), dict(w, n_iters=w["converged"] * ones))
    same = np.abs(g["us"] - w["us"]).max(axis=(0, 2)) < 1e-5
    assert same.mean() > 0.5
    for a, b in zip(grads, jgrads):
        a, b = a.numpy()[same], np.asarray(b)[same]
        np.testing.assert_allclose(a, b, atol=1e-3 * np.abs(b).max())
    config = dataclasses.replace(convert.mpc_config_from_jax(_jax_slew_config(4, 1e-5)), slew_rate_penalty=None)
    dx = PendulumDx.default(device="cpu").replace(params=torch.tensor(params))
    q, p = dx.get_true_obj()
    free = tdm.mpc_solve(config, torch.tensor(x), tdm.QuadCost(torch.diag(q), p), dx, u_lower=-2.0, u_upper=2.0)
    assert float((got.us[0] - 0.5).abs().mean()) < float((free.us[0] - 0.5).abs().mean())


# ---------------------------------------------------------------------------
# The slew penalty on the non-fused path, and u_zero_I (LinDx, float64)
# ---------------------------------------------------------------------------

LIN_T, LIN_B, LIN_N, LIN_M = 8, 6, 3, 2


def _lin_problem(seed):
    C, c, F, f, x0 = random_lqr_problem(np.random.default_rng(seed), LIN_T, LIN_B, LIN_N, LIN_M)
    return C, c, F, f, x0


def _jax_lin_solve(slew, mask, shared):
    config = jdm.MPCConfig(n_state=LIN_N, n_ctrl=LIN_M, T=LIN_T, lqr_iter=5, exit_unconverged=False,
                           detach_unconverged=False, slew_rate_penalty=slew, use_pallas=False)
    box = dict(u_lower=-1.0, u_upper=1.0) if slew else {}

    def loss(C, c, F, f, x0, prev):
        sol = jdm.mpc_solve(config, x0, jdm.QuadCost(C, c), jdm.LinDx(F, f), prev_ctrl=prev,
                            u_zero_I=None if mask is None else jnp.asarray(mask), **box)
        return jnp.sum(sol.us ** 2) + jnp.sum(sol.xs ** 2), sol

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4, 5), has_aux=True)), config, box


def _pinned_mask():
    mask = np.zeros((LIN_T, LIN_B, LIN_M), bool)
    mask[:, :, 1] = True
    return mask


_JAX_LIN = {
    "slew": _jax_lin_solve(1.0, None, True),
    "u_zero_I": _jax_lin_solve(None, _pinned_mask(), False),
    "u_zero_I_slew": _jax_lin_solve(1.0, _pinned_mask(), False),
}


@pytest.mark.parametrize("case", list(_JAX_LIN))
def test_lindx_slew_and_u_zero_I_match_jax_with_gradients(case, monkeypatch):
    """A float64 LinDx problem through the non-fused loop: with the slew
    penalty (box +-1, prev_ctrl, the cost shared over the batch, ``(nm,
    nm)``), with u_zero_I pinning the second control (unbounded otherwise:
    tests/test_mpc_knobs.py:108's problem), and both (:132's). The
    trajectory within 1e-6 of JAX's and the gradients of a loss with
    respect to C, c, F, f, x_init and prev_ctrl within 1e-6 of each
    max-abs; pinned controls exactly 0; the augmented state stripped; with
    a shared cost, the KKT backward reads the augmented C in place."""
    fn, jconfig, box = _JAX_LIN[case]
    C, c, F, f, x0 = _lin_problem(600 if case == "u_zero_I" else 601)
    if case == "slew":
        C, c = C[0, 0], c[0, 0]
    prev = np.random.default_rng(602).uniform(-0.5, 0.5, (LIN_B, LIN_M))
    mask = None if case == "slew" else _pinned_mask()
    (_, want), jgrads = fn(*(jnp.asarray(a) for a in (C, c, F, f, x0, prev)))
    seen = []
    orig = kkt_mod.kkt_backward_fused

    def recording(Ck, *args, **kw):
        seen.append(kkt_mod.reads_in_place(Ck))
        return orig(Ck, *args, **kw)

    monkeypatch.setattr(tdm.ops.library, "kkt_backward_fused", recording)
    leaves = [torch.tensor(a, requires_grad=True) for a in (C, c, F, f, x0, prev)]
    config = convert.mpc_config_from_jax(jconfig)
    sol = tdm.mpc_solve(config, leaves[4], tdm.QuadCost(leaves[0], leaves[1]), tdm.LinDx(leaves[2], leaves[3]),
                        prev_ctrl=leaves[5], u_zero_I=None if mask is None else torch.tensor(mask), **box)
    grads = torch.autograd.grad((sol.us ** 2).sum() + (sol.xs ** 2).sum(), leaves, allow_unused=True)
    assert sol.xs.shape == (LIN_T, LIN_B, LIN_N)
    np.testing.assert_allclose(sol.us.detach().numpy(), np.asarray(want.us), atol=1e-6)
    np.testing.assert_allclose(sol.xs.detach().numpy(), np.asarray(want.xs), atol=1e-6)
    for name, a, b in zip(("C", "c", "F", "f", "x_init", "prev_ctrl"), grads, jgrads):
        b = np.asarray(b)
        a = np.zeros_like(b) if a is None else a.numpy()
        np.testing.assert_allclose(a, b, atol=1e-6 * max(1.0, np.abs(b).max()), err_msg=name)
    if mask is not None:
        assert bool((sol.us[..., 1] == 0).all()) and float(sol.us[..., 0].abs().max()) > 0
    assert seen == [case == "slew"]


def test_u_zero_I_equals_the_problem_without_the_pinned_dim():
    """tests/test_mpc_knobs.py:108's second check: the pinned solve's free
    control equals the m = 1 solve with the pinned dim's rows and columns
    removed, within 1e-5."""
    C, c, F, f, x0 = _lin_problem(600)
    config = tdm.MPCConfig(n_state=LIN_N, n_ctrl=LIN_M, T=LIN_T, lqr_iter=5, exit_unconverged=False)
    T_ = torch.tensor
    sol = tdm.mpc_solve(config, T_(x0), tdm.QuadCost(T_(C), T_(c)), tdm.LinDx(T_(F), T_(f)),
                        u_zero_I=T_(_pinned_mask()))
    keep = [0, 1, 2, 3]
    one = tdm.mpc_solve(dataclasses.replace(config, n_ctrl=1), T_(x0),
                        tdm.QuadCost(T_(C[..., keep, :][..., :, keep]), T_(c[..., keep])),
                        tdm.LinDx(T_(F[..., :, keep]), T_(f)))
    np.testing.assert_allclose(sol.us[..., :1].numpy(), one.us.numpy(), atol=1e-5)


def test_u_zero_I_on_the_fused_path_is_the_zero_box():
    """The vehicle's steering pinned by u_zero_I on the fused path: the
    steering exactly 0, the acceleration at work, and the solve bit-equal
    to the one whose steering box is [0, 0] (the same degenerate box)."""
    dx = VehicleDx.default(device="cpu")
    q, p = dx.get_true_obj()
    rng = np.random.default_rng(603)
    B, T = 8, 6
    x0 = torch.tensor(np.stack([np.zeros(B), rng.uniform(-1, 1, B), rng.uniform(-0.3, 0.3, B), rng.uniform(3, 7, B)],
                               -1), dtype=torch.float32)
    config = tdm.MPCConfig(n_state=4, n_ctrl=2, T=T, lqr_iter=4, eps=1e-5, exit_unconverged=False)
    lo = torch.tensor([-dx.max_brake, -dx.max_steer])
    hi = torch.tensor([dx.max_accel, dx.max_steer])
    cost = tdm.QuadCost(torch.diag(q), p)
    calls = []
    orig = tdm.mpc.ilqr_solve_fused
    try:
        tdm.mpc.ilqr_solve_fused = lambda *a, **k: calls.append(1) or orig(*a, **k)
        pinned = tdm.mpc_solve(config, x0, cost, dx, u_lower=lo, u_upper=hi, u_zero_I=torch.tensor([False, True]))
    finally:
        tdm.mpc.ilqr_solve_fused = orig
    boxed = tdm.mpc_solve(config, x0, cost, dx, u_lower=lo * torch.tensor([1.0, 0.0]),
                          u_upper=hi * torch.tensor([1.0, 0.0]))
    assert calls == [1]
    assert bool((pinned.us[..., 1] == 0).all()) and float(pinned.us[..., 0].abs().max()) > 1e-3
    assert torch.equal(pinned.us, boxed.us) and torch.equal(pinned.objs, boxed.objs)


# ---------------------------------------------------------------------------
# The control-passthrough kernels, built for the host
# ---------------------------------------------------------------------------

# The fused solve and the line search over a variant's env, each unit from
# the macros of its passthrough variant (variant_defines) plus PT_NAME for
# its symbols, at every DMPC_LANES count.
SHIM_PT = r"""
#include <vector>

#include "variants/variant.cuh"

#include "ilqr.cuh"
#include "rollout.cuh"

#define PT_CAT2(a, b) a##b
#define PT_CAT(a, b) PT_CAT2(a, b)
#ifdef DMPC_HIDDEN
using Env = VariantNNEnv;
#else
using Env = VariantCppEnv;
#endif

template <int L>
static int pt_ilqr_group(const IlqrArgs* a, const Env* env) {
  if (!ilqr_lane_scratch_ok<Env, L>(*a)) return 1;
  std::vector<float> slots(ilqr_group_floats<Env::N, Env::M, kVariantSharedSweep, L>());
  const HostLanes<L> g{slots.data()};
  for (int b = 0; b < a->B; ++b)
    ilqr_solve_scenario<Env::N, Env::M, false, kPnqpEnumDefault, false, kVariantSharedSweep>(*a, *env, b, g);
  return 0;
}

template <bool STREAM, int L>
static int pt_rollout_group(const RolloutArgs* a, const Env* env) {
  if (!rollout_lane_scratch_ok<L>(*a)) return 1;
  std::vector<float> slots(rollout_group_slot_floats<Env::N, Env::M, Env, L>());
  const HostLanes<L> g{slots.data()};
  for (int b = 0; b < a->B; ++b) linesearch_rollout_scenario<Env::N, Env::M, STREAM>(*a, *env, b, a->params, g);
  return 0;
}

extern "C" int PT_CAT(diffmpc_ilqr_solve_host_pt_, PT_NAME)(const IlqrArgs* a, const Env* env) {
  switch (a->lanes) {
#define HOST_PT_LANE_CASE(_, L_) \
  case L_:                       \
    return pt_ilqr_group<L_>(a, env);
    DMPC_LANES(HOST_PT_LANE_CASE, _)
#undef HOST_PT_LANE_CASE
  }
  return 1;
}

extern "C" int PT_CAT(diffmpc_rollout_host_pt_, PT_NAME)(const RolloutArgs* a, const Env* env, int stream) {
  switch (a->lanes) {
#define HOST_PT_ROLLOUT_CASE(_, L_) \
  case L_:                          \
    return stream ? pt_rollout_group<true, L_>(a, env) : pt_rollout_group<false, L_>(a, env);
    DMPC_LANES(HOST_PT_ROLLOUT_CASE, _)
#undef HOST_PT_ROLLOUT_CASE
  }
  return 1;
}
"""


def _pt_models():
    """The wrapped models of the host build, float32 on the CPU."""
    gen = torch.Generator().manual_seed(610)
    mlp = NNDynamics.init(3, 2, hidden=(8,), residual=True, device="cpu", generator=gen)
    return {
        "pendulum": CtrlPassthroughDynamics(inner=PendulumDx.default(device="cpu"), n_ctrl=1),
        "vehicle": CtrlPassthroughDynamics(inner=VehicleDx.default(device="cpu"), n_ctrl=2),
        "mlp": CtrlPassthroughDynamics(inner=mlp.replace(weights=tuple(0.5 * w for w in mlp.weights)), n_ctrl=2),
    }


@pytest.fixture(scope="module")
def pt_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of the kernel headers needs it")
    d = tmp_path_factory.mktemp("passthrough_host")
    (d / "shim_pt.cpp").write_text(SHIM_PT)
    flags = [gxx, "-O2", "-std=c++17", "-fPIC", "-I", build.CSRC]
    procs, objs = [], []
    for name, dyn in _pt_models().items():
        key = ilqr_mod.env_variant_key(ilqr_mod.kernel_env(dyn), "ilqr")
        objs.append(str(d / f"shim_pt_{name}.o"))
        procs.append(subprocess.Popen([*flags, *build.variant_defines(key), f"-DPT_NAME={name}", "-c", "-o", objs[-1],
                                       str(d / "shim_pt.cpp")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    for proc in procs:
        _, err = proc.communicate()
        assert proc.returncode == 0, err
    so = d / "libshim_pt.so"
    proc = subprocess.run([*flags, "-shared", "-o", str(so), *objs], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))


def _pt_problem(name, B=8, T=8, seed=611):
    """The wrapped model's fused-solve inputs: the inner start with a
    random carried control in front, a goal cost on the inner state with a
    slew penalty of 1 between the carried and the new control, and a box."""
    dyn = _pt_models()[name]
    n, m = ilqr_mod.kernel_env(dyn).n, dyn.n_ctrl
    rng = np.random.default_rng(seed)
    if name == "pendulum":
        th = rng.uniform(-np.pi, np.pi, B)
        x = np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, B)], -1)
        lo, hi = [-2.0], [2.0]
    elif name == "vehicle":
        x = np.stack([np.zeros(B), rng.uniform(-1, 1, B), rng.uniform(-0.3, 0.3, B), rng.uniform(3, 7, B)], -1)
        lo, hi = [-6.0, -0.5], [3.0, 0.5]
    else:
        x = 0.5 * rng.standard_normal((B, 3))
        lo, hi = [-1.0, -1.0], [1.0, 1.0]
    x = np.concatenate([rng.uniform(-0.5, 0.5, (B, m)), x], -1)
    q = np.concatenate([np.zeros(m), np.ones(n - m), 0.1 * np.ones(m)])
    Cm = np.diag(q)
    for i in range(m):
        Cm[i, i] += 1.0
        Cm[n + i, n + i] += 1.0
        Cm[i, n + i] = Cm[n + i, i] = -1.0
    f32 = dict(dtype=torch.float32)
    C = torch.tensor(Cm, **f32).expand(T, B, n + m, n + m)
    c = torch.tensor(-0.3 * rng.standard_normal(n + m), **f32).expand(T, B, n + m)
    box = [torch.tensor(b, **f32).expand(T, B, m).contiguous() for b in (lo, hi)]
    return torch.tensor(x, **f32), C, c, dyn, *box


def _ilqr_pt_launcher(lib, name, dyn):
    fn = getattr(lib, f"diffmpc_ilqr_solve_host_pt_{name}")
    fn.argtypes = [ctypes.POINTER(_IlqrArgs), ctypes.POINTER(type(ilqr_mod.kernel_env(dyn).struct))]
    fn.restype = ctypes.c_int

    def launch(args, env):
        assert fn(args, env) == 0, "refused: a lane count that is not built, or lane scratch against the rule"

    return launch


def _assert_equal_results(got, want):
    for a, b, f in zip(got, want, got._fields):
        assert torch.equal(a.isnan(), b.isnan()), f
        assert torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)), f


@pytest.mark.parametrize("name", ["pendulum", "vehicle", "mlp"])
def test_host_build_passthrough_solve_matches_plain_and_equals_one_lane(pt_lib, name):
    """The wrapped env's fused solve (B=8, T=8; the variant build's shared
    sweep): one iteration within 1e-4 of the plain version with n_iters
    equal, the carried control of every step after the first equal to the
    step before's control; every built lane count bit-equal to one lane over
    three iterations, cold and warm-started from the cold solve's controls
    shifted one step."""
    args = _pt_problem(name)
    launch = _ilqr_pt_launcher(pt_lib, name, args[3])
    first = dict(lqr_iter=1, eps=0.0)
    got = run_staged(launch, *args, **first)
    assert_tight(as_numpy(got), as_numpy(ilqr_solve_plain(*args, **first)))
    m = args[3].n_ctrl
    assert torch.equal(got.xs[1:, :, :m], got.us[:-1])
    three = dict(lqr_iter=3, eps=1e-5, decay=0.8)
    cold = run_staged(launch, *args, **three)
    for u_init in (None, torch.cat([cold.us[1:], cold.us[-1:]], 0)):
        one = run_staged(launch, *args, u_init=u_init, **three)
        for lanes in ILQR_LANES[1:]:
            _assert_equal_results(run_staged(launch, *args, u_init=u_init, lanes=lanes, **three), one)


@pytest.mark.parametrize("name", ["pendulum", "vehicle", "mlp"])
def test_host_build_passthrough_line_search_matches_plain_and_equals_one_lane(pt_lib, name):
    """The wrapped env's line search on the non-fused loop's inputs (a
    rollout of random controls in the box, the box sweep's gains about it,
    the feedforward scaled by up to 8): the resident kernel's host build
    within 1e-5 (relative) of the plain version with alpha equal, and every
    built lane count of it and of the twin bit-equal to one lane."""
    x0, C, c, dyn, lo, hi = _pt_problem(name, seed=612)
    T, B = C.shape[:2]
    n = ilqr_mod.kernel_env(dyn).n
    gen = torch.Generator().manual_seed(613)
    u_hat = lo + (hi - lo) * torch.rand(lo.shape, generator=gen)
    xs = [x0]
    for t in range(T - 1):
        xs.append(dyn.forward(xs[-1], u_hat[t]))
    x_hat = torch.stack(xs)
    F, _ = linearize_dynamics(dyn, x_hat, u_hat)
    gains = riccati_backward_plain(C, c + bmv(C, torch.cat([x_hat, u_hat], -1)), F, None, n, u_lower=lo, u_upper=hi,
                                   u_hat=u_hat)
    k = gains.k * (0.5 + 7.5 * torch.rand((1, B, 1), generator=gen))
    ls_args, kw = (x0, C, c, None, None, gains.K, k, x_hat, u_hat), dict(u_lower=lo, u_upper=hi, dyn=dyn)
    fn = getattr(pt_lib, f"diffmpc_rollout_host_pt_{name}")
    fn.argtypes = [ctypes.POINTER(_RolloutArgs), ctypes.POINTER(type(ilqr_mod.kernel_env(dyn).struct)), ctypes.c_int]
    fn.restype = ctypes.c_int

    def launcher(stream):
        def launch(args, n_, m_, env):
            assert fn(args, env, stream) == 0

        return launch

    got = run_staged_rollout(launcher(0), *ls_args, **kw)
    want = linesearch_rollout_plain(*ls_args, **kw)
    assert torch.equal(got.alpha, want.alpha) and torch.equal(got.improved, want.improved)
    scale = float(want.objs.abs().max())
    np.testing.assert_allclose(got.objs.numpy(), want.objs.numpy(), atol=1e-5 * scale)
    np.testing.assert_allclose(got.us.numpy(), want.us.numpy(), atol=1e-5 * max(1.0, float(want.us.abs().max())))
    for stream in (0, 1):
        for lanes in ROLLOUT_LANES:
            _assert_equal_results(run_staged_rollout(launcher(stream), *ls_args, lanes=lanes, **kw), got)
