"""The long-horizon slice against the JAX package: the rollout twin, and
``mpc_solve`` with its gradient on box-DDP config 2 through the twins.

- The rollout twin's port entry on CPU tensors (its plain version,
  re-exported by ``ops/cuda/rollout_stream.py``) against the JAX twin
  ``linesearch_rollout_pallas_stream`` in interpret mode, with the recipe of
  tests/test_pallas_rollout_stream.py (T=7-9, B=32-48, decay 0.5, six
  steps): linear dynamics with and without a box, and the pendulum's step.
  ``xs, us, objs`` within 1e-5 relative (1e-5 of the largest entry as the
  floor), ``alpha`` and ``improved`` equal (at decay 0.5 the JAX twin's
  ``decay**j`` and the port's rolled ladder are the same floats).
- The slice: ``mpc_solve`` on BASELINE.json config 2 (LinDx n=4, m=2, box
  +-0.6, lqr_iter 10) and the gradient of a fixed loss in ``xs, us`` with
  respect to ``x_init, C, c, F, f``, in both packages, with both VMEM budgets
  set small so that T=12 takes the twins (the JAX package with
  ``use_pallas=True, pallas_interpret=True``). Objectives within 1e-5
  relative; controls within 1e-4 on >= 90% of the scenarios and 5e-3 on all
  (a box QP flat in float32 may leave a scenario elsewhere at the same
  objective, chip_smoke.py phase 11); gradients within 1e-3 of their max-abs
  on the scenarios that reach the same fixed point (controls within 1e-4).
- The routing of the slice at its real horizon (T=128) and at T=20, with the
  CUDA entry points replaced by recorders that run the plain versions: at
  T=128 each iteration takes the Riccati and the rollout twins and the
  gradient the KKT twin, and no resident kernel; at T=20 the reverse.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import diffmpc_tpu as jdm  # noqa: E402
import diffmpc_tpu_torch as tdm  # noqa: E402
from diffmpc_tpu.models import PendulumDx as JaxPendulumDx  # noqa: E402
from diffmpc_tpu.ops.lqr import lqr_rollout as jax_lqr_rollout  # noqa: E402
from diffmpc_tpu.ops.lqr import riccati_backward as jax_riccati  # noqa: E402
from diffmpc_tpu.ops.linearize import linearize_dynamics as jax_linearize  # noqa: E402
from diffmpc_tpu.ops.pallas import riccati as jric  # noqa: E402
from diffmpc_tpu.ops.pallas.rollout_stream import linesearch_rollout_pallas_stream  # noqa: E402
from diffmpc_tpu_torch import convert  # noqa: E402
from diffmpc_tpu_torch.ops import lqr as tlqr  # noqa: E402
from diffmpc_tpu_torch.ops.cuda import horizon, kkt, kkt_stream, rollout_stream  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.kkt import kkt_backward_plain  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.riccati import riccati_backward_plain  # noqa: E402
from oracles import random_lqr_problem  # noqa: E402

BOX = 0.6
DECAY, MAX_ITER = 0.5, 6


# ---------------------------------------------------------------------------
# The rollout twin.
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("pendulum",))
def jax_rollout_twin(args, lo, hi, *, pendulum):
    dyn = JaxPendulumDx.default(jnp.float32) if pendulum else None
    return linesearch_rollout_pallas_stream(
        *args, u_lower=lo, u_upper=hi, dyn=dyn, decay=DECAY, max_iter=MAX_ITER, interpret=True
    )


def linear_case(constrained):
    """tests/test_pallas_rollout_stream.py's linear recipe (T=7, B=48, n=3,
    m=2), with the feedforward scaled by up to 8 per scenario so that the
    ladder backs off."""
    T, B, n, m = 7, 48, 3, 2
    rng = np.random.default_rng(1910 + constrained)
    C, c, F, f, x_init = (jnp.asarray(a, jnp.float32) for a in random_lqr_problem(rng, T, B, n, m))
    u_hat = jnp.zeros((T, B, m), jnp.float32)
    x_hat, _ = jax_lqr_rollout(x_init, F, f, jnp.zeros((T, B, m, n), jnp.float32), u_hat)
    c_delta = c + jnp.einsum("tbij,tbj->tbi", C, jnp.concatenate([x_hat, u_hat], -1))
    lo = hi = None
    kw = {}
    if constrained:
        lo, hi = jnp.full((T, B, m), -0.5, jnp.float32), jnp.full((T, B, m), 0.5, jnp.float32)
        kw = dict(u_lower=lo, u_upper=hi, u_hat=u_hat)
    res = jax_riccati(C, c_delta, F, None, n, **kw)
    k = res.k * jnp.asarray(rng.uniform(0.5, 8.0, (1, B, 1)), jnp.float32)
    return (x_init, C, c, F, f, res.K, k, x_hat, u_hat), lo, hi


def pendulum_case():
    """tests/test_pallas_rollout_stream.py's pendulum recipe (T=9, B=32)."""
    T, B = 9, 32
    dx = JaxPendulumDx.default(jnp.float32)
    q, p = dx.get_true_obj()
    rng = np.random.default_rng(1912)
    th = rng.uniform(-np.pi, np.pi, B)
    x_init = jnp.asarray(np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, B)], -1), jnp.float32)
    u_hat = jnp.zeros((T, B, 1), jnp.float32)
    _, x_hat = jax.lax.scan(lambda x, ut: (dx.forward(x, ut), x), x_init, u_hat)
    C = jnp.broadcast_to(jnp.diag(q), (T, B, 4, 4)).astype(jnp.float32)
    c = jnp.broadcast_to(p, (T, B, 4)).astype(jnp.float32)
    lin = jax_linearize(dx, x_hat, u_hat)
    c_delta = c + jnp.einsum("tbij,tbj->tbi", C, jnp.concatenate([x_hat, u_hat], -1))
    lo, hi = jnp.full((T, B, 1), -2.0, jnp.float32), jnp.full((T, B, 1), 2.0, jnp.float32)
    res = jax_riccati(C, c_delta, lin.F, None, 3, u_lower=lo, u_upper=hi, u_hat=u_hat)
    k = res.k * jnp.asarray(rng.uniform(0.5, 8.0, (1, B, 1)), jnp.float32)
    return (x_init, C, c, None, None, res.K, k, x_hat, u_hat), lo, hi, dx


def tensors(*arrays):
    return [None if a is None else torch.tensor(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("case", ["linear_free", "linear_box", "pendulum"])
def test_rollout_twin_matches_jax_twin(case):
    if case == "pendulum":
        args, lo, hi, jdx = pendulum_case()
        dyn = convert.pendulum_from_jax(jdx, device="cpu")
    else:
        (args, lo, hi), dyn = linear_case(case == "linear_box"), None
    want = jax_rollout_twin(args, lo, hi, pendulum=dyn is not None)
    lo_t, hi_t = tensors(lo, hi)
    got = rollout_stream.linesearch_rollout_plain(
        *tensors(*args), u_lower=lo_t, u_upper=hi_t, dyn=dyn, decay=DECAY, max_iter=MAX_ITER
    )
    for name in ("xs", "us", "objs"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.dtype == np.float32, name
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max(), err_msg=name)
    np.testing.assert_array_equal(got.alpha.numpy(), np.asarray(want.alpha))
    np.testing.assert_array_equal(got.improved.numpy(), np.asarray(want.improved))
    assert len(np.unique(got.alpha.numpy())) > 1  # the ladder backs off


# ---------------------------------------------------------------------------
# The slice: mpc_solve and its gradient through the twins.
# ---------------------------------------------------------------------------

ST, SB, SN, SM = 12, 16, 4, 2


@functools.partial(jax.jit, static_argnames=("config",))
def jax_slice(config, x0, C, c, F, f, wx, wu):
    def loss(*leaves):
        sol = jdm.mpc_solve(config, *leaves[:1], jdm.QuadCost(*leaves[1:3]), jdm.LinDx(*leaves[3:]),
                            u_lower=-BOX, u_upper=BOX)
        return jnp.sum(sol.xs * wx) + jnp.sum(sol.us * wu), sol

    (_, sol), grads = jax.value_and_grad(loss, argnums=range(5), has_aux=True)(x0, C, c, F, f)
    return sol, grads


def test_slice_matches_jax_through_the_twins(monkeypatch):
    budget = 1 << 20
    monkeypatch.setattr(horizon, "VMEM_BUDGET_BYTES", budget)
    monkeypatch.setattr(jric, "VMEM_BUDGET_BYTES", budget)
    assert jric.riccati_vmem_bytes(ST, SN, SM) > budget  # the JAX package streams too
    assert horizon.streams_riccati(ST, SN, SM) and horizon.streams_rollout(ST, SN, SM) and horizon.streams_kkt(ST, SN, SM)
    rng = np.random.default_rng(1950)
    C, c, F, f, x0 = (a.astype(np.float32) for a in random_lqr_problem(rng, ST, SB, SN, SM))
    wx = rng.normal(size=(ST, SB, SN)).astype(np.float32)
    wu = rng.normal(size=(ST, SB, SM)).astype(np.float32)
    jconfig = jdm.MPCConfig(
        n_state=SN, n_ctrl=SM, T=ST, lqr_iter=10, exit_unconverged=False, detach_unconverged=False,
        use_pallas=True, pallas_interpret=True,
    )
    want, want_g = jax_slice(jconfig, *map(jnp.asarray, (x0, C, c, F, f, wx, wu)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x0, C, c, F, f)]
    got = tdm.mpc_solve(
        convert.mpc_config_from_jax(jconfig), leaves[0], tdm.QuadCost(leaves[1], leaves[2]),
        tdm.LinDx(leaves[3], leaves[4]), u_lower=-BOX, u_upper=BOX,
    )
    got_g = torch.autograd.grad((got.xs * torch.tensor(wx)).sum() + (got.us * torch.tensor(wu)).sum(), leaves)
    np.testing.assert_allclose(got.objs.detach().numpy(), np.asarray(want.objs), rtol=1e-5, atol=1e-5)
    us_diff = np.abs(got.us.detach().numpy() - np.asarray(want.us)).max(axis=(0, 2))
    same = us_diff <= 1e-4  # the scenarios at the same fixed point
    # one scenario of these 16 (b = 11) parts by 4.6e-4 at the same objective
    # (within 2e-7): a float32-flat valley of a box QP, where the JAX
    # package's XLA path parts from the port's plain version alike
    assert same.mean() >= 0.9 and us_diff.max() <= 5e-3, us_diff
    assert float(got.info.clamp_frac.mean()) > 0.05  # the box binds
    for name, g, w in zip(("x_init", "C", "c", "F", "f"), got_g, want_g):
        w = np.asarray(w)
        g = g.numpy()[same] if name == "x_init" else g.numpy()[:, same]
        w = w[same] if name == "x_init" else w[:, same]
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g, w, atol=1e-3 * np.abs(w).max(), rtol=0, err_msg=name)


@pytest.mark.parametrize("T,twins", [(128, True), (20, False)], ids=["T128_twins", "T20_resident"])
def test_slice_routes_by_horizon(monkeypatch, T, twins):
    """With the CUDA entry points replaced by recorders (the plain versions
    underneath) and the CPU tensors taken for the card's, config 2 routes
    each kernel call by its horizon."""
    calls = []

    def recorder(name, plain):
        def run(*args, **kw):
            calls.append(name)
            return plain(*args, **kw)
        return run

    monkeypatch.setattr(tlqr, "resolve_use_cuda", lambda use_cuda, device: True)
    monkeypatch.setattr(kkt, "resolve_use_cuda", lambda use_cuda, device: True)
    monkeypatch.setattr(tlqr, "riccati_backward_cuda", recorder("riccati", riccati_backward_plain))
    monkeypatch.setattr(tlqr, "riccati_backward_stream_cuda", recorder("riccati_stream", riccati_backward_plain))
    monkeypatch.setattr(tlqr, "linesearch_rollout_cuda", recorder("rollout", tlqr.linesearch_rollout_plain))
    monkeypatch.setattr(tlqr, "linesearch_rollout_stream_cuda", recorder("rollout_stream", tlqr.linesearch_rollout_plain))
    monkeypatch.setattr(kkt, "run_on_card", lambda launcher, *a, **kw: recorder("kkt", kkt_backward_plain)(*a, **kw))
    monkeypatch.setattr(kkt_stream, "kkt_backward_stream_cuda", recorder("kkt_stream", kkt_backward_plain))
    B = 3
    rng = np.random.default_rng(1960)
    leaves = [torch.tensor(a.astype(np.float32), requires_grad=True) for a in random_lqr_problem(rng, T, B, SN, SM)]
    C, c, F, f, x0 = leaves
    config = tdm.MPCConfig(n_state=SN, n_ctrl=SM, T=T, lqr_iter=2, exit_unconverged=False)
    sol = tdm.mpc_solve(config, x0, tdm.QuadCost(C, c), tdm.LinDx(F, f), u_lower=-BOX, u_upper=BOX)
    it = int(sol.info.n_iters)
    forward = list(calls)
    torch.autograd.grad(sol.us.sum(), (x0, C))
    suffix = "_stream" if twins else ""
    assert forward == [f"riccati{suffix}", f"rollout{suffix}"] * it
    assert calls[len(forward):] == [f"kkt{suffix}"]
