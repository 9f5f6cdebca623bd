"""The port's line-search rollout (kernel B's plain version) against the JAX
package's Pallas kernel ``linesearch_rollout_pallas`` in interpret mode, on
the same inputs (the recipe of tests/test_pallas_rollout.py: T=8, B=32,
decay 0.5, max_iter 6): linear dynamics with and without a box and a
``delta_u`` trust region, and the pendulum's own step. ``xs, us, objs``
within 1e-5 relative (both compute in float32 in the same order; the rest is
summation and ``sin``/``cos`` rounding); ``alpha`` and ``improved`` equal.
"""

import functools
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffmpc_tpu.models import PendulumDx as JaxPendulumDx  # noqa: E402
from diffmpc_tpu.ops.lqr import lqr_rollout as jax_lqr_rollout  # noqa: E402
from diffmpc_tpu.ops.lqr import riccati_backward as jax_riccati  # noqa: E402
from diffmpc_tpu.ops.linearize import linearize_dynamics as jax_linearize  # noqa: E402
from diffmpc_tpu.ops.pallas.rollout import linesearch_rollout_pallas  # noqa: E402
from diffmpc_tpu_torch import convert  # noqa: E402
from diffmpc_tpu_torch.models import NNDynamics, PendulumDx  # noqa: E402
from diffmpc_tpu_torch.csrc.build import VariantKey  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.ilqr import env_variant_key, kernel_env  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.rollout import (  # noqa: E402
    ROLLOUT_LANES,
    linesearch_rollout_cuda,
    linesearch_rollout_plain,
    rollout_lanes,
    run_staged_rollout,
)
from diffmpc_tpu_torch.ops.cuda.rollout_stream import linesearch_rollout_stream_cuda  # noqa: E402
from diffmpc_tpu_torch.ops.lqr import lqr_linesearch_rollout, lqr_rollout  # noqa: E402
from oracles import random_lqr_problem  # noqa: E402

T, B = 8, 32
DECAY, MAX_ITER = 0.5, 6


@functools.partial(jax.jit, static_argnames=("delta_u", "pendulum", "decay", "unroll"))
def jax_linesearch(args, lo, hi, *, delta_u, pendulum, decay=DECAY, unroll=False):
    dyn = JaxPendulumDx.default(jnp.float32) if pendulum else None
    return linesearch_rollout_pallas(
        *args, u_lower=lo, u_upper=hi, delta_u=delta_u, dyn=dyn, decay=decay, max_iter=MAX_ITER,
        interpret=True, unroll=unroll,
    )


def linear_case(constrained, delta_u=None, n=3, m=2, seed=90):
    """Gains from the XLA Riccati about a random-control trajectory, as in
    tests/test_pallas_rollout.py, with the feedforward ``k`` scaled by up to
    8 per scenario: the full step then overshoots in some scenarios, so the
    ladder has to back off."""
    rng = np.random.default_rng(seed + constrained)
    C, c, F, f, x_init = (jnp.asarray(a, jnp.float32) for a in random_lqr_problem(rng, T, B, n, m))
    u_hat = jnp.asarray(rng.uniform(-0.2, 0.2, (T, B, m)), jnp.float32)
    x_hat, _ = jax_lqr_rollout(x_init, F, f, jnp.zeros((T, B, m, n), jnp.float32), u_hat)
    c_delta = c + jnp.einsum("tbij,tbj->tbi", C, jnp.concatenate([x_hat, u_hat], -1))
    lo = hi = None
    kw = {}
    if constrained:
        lo = jnp.full((T, B, m), -1.5, jnp.float32)
        hi = jnp.full((T, B, m), 1.5, jnp.float32)
        kw = dict(u_lower=lo, u_upper=hi, u_hat=u_hat)
    res = jax_riccati(C, c_delta, F, None, n, **kw)
    k = res.k * jnp.asarray(rng.uniform(0.5, 8.0, (1, B, 1)), jnp.float32)
    return (x_init, C, c, F, f, res.K, k, x_hat, u_hat), lo, hi


def pendulum_case():
    """tests/test_pallas_rollout.py's pendulum recipe: goal cost, box +-2,
    the env linearized about its zero-control rollout."""
    dx = JaxPendulumDx.default(jnp.float32)
    q, p = dx.get_true_obj()
    rng = np.random.default_rng(95)
    th = rng.uniform(-np.pi, np.pi, B)
    x_init = jnp.asarray(np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, B)], -1), jnp.float32)
    u_hat = jnp.zeros((T, B, 1), jnp.float32)
    _, x_hat = jax.lax.scan(lambda x, ut: (dx.forward(x, ut), x), x_init, u_hat)
    C = jnp.broadcast_to(jnp.diag(q), (T, B, 4, 4)).astype(jnp.float32)
    c = jnp.broadcast_to(p, (T, B, 4)).astype(jnp.float32)
    lin = jax_linearize(dx, x_hat, u_hat)
    c_delta = c + jnp.einsum("tbij,tbj->tbi", C, jnp.concatenate([x_hat, u_hat], -1))
    lo = jnp.full((T, B, 1), -2.0, jnp.float32)
    hi = jnp.full((T, B, 1), 2.0, jnp.float32)
    res = jax_riccati(C, c_delta, lin.F, None, 3, u_lower=lo, u_upper=hi, u_hat=u_hat)
    return (x_init, C, c, lin.F, lin.f, res.K, res.k, x_hat, u_hat), lo, hi, dx


def tensors(*arrays):
    return [None if a is None else torch.tensor(np.asarray(a)) for a in arrays]


def assert_matches(got, want):
    for name in ("xs", "us", "objs"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.dtype == np.float32, name
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max(), err_msg=name)
    np.testing.assert_array_equal(got.alpha.numpy(), np.asarray(want.alpha))
    np.testing.assert_array_equal(got.improved.numpy(), np.asarray(want.improved))


@pytest.mark.parametrize(
    "constrained,delta_u", [(False, None), (True, None), (True, 0.3)], ids=["free", "box", "box_delta_u"]
)
def test_plain_matches_jax_pallas_kernel_linear(constrained, delta_u):
    args, lo, hi = linear_case(constrained)
    want = jax_linesearch(args, lo, hi, delta_u=delta_u, pendulum=False)
    lo_t, hi_t = tensors(lo, hi)
    got = linesearch_rollout_plain(
        *tensors(*args), u_lower=lo_t, u_upper=hi_t, delta_u=delta_u, decay=DECAY, max_iter=MAX_ITER
    )
    assert_matches(got, want)
    if delta_u is None:  # the ladder backs off (a tight trust region keeps alpha = 1)
        assert len(np.unique(got.alpha.numpy())) > 2


def test_plain_matches_jax_pallas_kernel_pendulum():
    args, lo, hi, jdx = pendulum_case()
    want = jax_linesearch(args, lo, hi, delta_u=None, pendulum=True)
    lo_t, hi_t = tensors(lo, hi)
    got = linesearch_rollout_plain(
        *tensors(*args), u_lower=lo_t, u_upper=hi_t, dyn=convert.pendulum_from_jax(jdx, device="cpu"),
        decay=DECAY, max_iter=MAX_ITER,
    )
    assert_matches(got, want)


@pytest.mark.parametrize("case", ["linear", "pendulum"])
def test_unroll_matches_jax_unroll(case):
    """``unroll=True``, the ladder ``alpha = decay**k`` rounded once to
    float32 (the JAX kernel's round-1 exact-power ladder): the plain version
    against the JAX kernel's ``unroll=True`` in interpret mode within 1e-4
    (the slice's parity budget), ``alpha`` and ``improved`` equal, at decay
    0.2, where the powers part from the rolled ladder's float32 products
    from k = 2 on. The feedforward is scaled up (by 10, and 16 for the
    pendulum) so that some scenarios back off to k = 2. The streaming twin
    has no ``unroll``, as the JAX twin has none."""
    decay = 0.2
    if case == "linear":
        args, lo, hi = linear_case(True, seed=310)
        dyn = jdx = None
    else:
        args, lo, hi, jdx = pendulum_case()
        dyn = convert.pendulum_from_jax(jdx, device="cpu")
    args = args[:6] + (args[6] * (10.0 if jdx is None else 16.0),) + args[7:]
    want = jax_linesearch(args, lo, hi, delta_u=None, pendulum=jdx is not None, decay=decay, unroll=True)
    lo_t, hi_t = tensors(lo, hi)
    got = linesearch_rollout_plain(
        *tensors(*args), u_lower=lo_t, u_upper=hi_t, dyn=dyn, decay=decay, max_iter=MAX_ITER, unroll=True
    )
    for name in ("xs", "us", "objs"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(w).max()), err_msg=name)
    np.testing.assert_array_equal(got.alpha.numpy(), np.asarray(want.alpha))
    np.testing.assert_array_equal(got.improved.numpy(), np.asarray(want.improved))
    powers = np.array([decay**k for k in range(MAX_ITER)], np.float32)
    assert np.isin(got.alpha.numpy(), powers).all() and (got.alpha.numpy() == powers[2]).any()
    assert "unroll" not in inspect.signature(linesearch_rollout_stream_cuda).parameters


# ``diagnostics/ab_rollout_lanes.py`` on an NVIDIA H100 80GB HBM3 at 700 W
# (132 SMs): the kernel the dispatch takes, alone, on every line search of
# one mpc_solve, summed, ms at L = 1 / 2 / 4 / 16 (the table beside
# ``rollout_lanes``)
ROLLOUT_LANE_SCAN_MS = {
    ("linear", 20): {
        128: (0.588, 0.511, 0.409, 0.504),
        4096: (0.716, 0.617, 0.607, 1.449),
        16384: (1.164, 1.486, 2.135, 5.174),
        65536: (3.923, 5.753, 8.098, 19.867),
    },
    ("linear", 128): {
        128: (8.277, 6.349, 5.070, 6.333),
        4096: (8.522, 8.870, 8.586, 18.114),
        16384: (14.304, 18.949, 28.466, 74.323),
        65536: (52.936, 76.883, 115.308, 304.931),
    },
    ("pendulum", 20): {1024: (1.027, 0.752, 0.574, 0.471), 65536: (2.955, 2.784, 3.632, 7.282)},
    ("pendulum", 256): {1024: (12.316, 9.338, 6.827, 3.678)},
    ("mlp_3_16_16_3", 15): {1024: (7.318, 3.820, 2.549, 1.344), 65536: (11.470, 9.967, 7.893, 14.510)},
    ("mlp_3_16_16_3", 128): {1024: (25.541, 14.767, 9.971, 5.175), 65536: (50.118, 39.229, 36.205, 80.665)},
}


@pytest.mark.parametrize("case,T", sorted(ROLLOUT_LANE_SCAN_MS))
def test_rollout_lane_rule_picks_the_fastest_measured_lane_count(case, T):
    """``rollout_lanes`` on a 132-SM card: at each batch of the measured
    scan (``ROLLOUT_LANE_SCAN_MS``) it picks a built lane count whose time
    is within 10% of the fastest one's there; never more lanes as the batch
    grows."""
    if case == "linear":
        env = None
    elif case == "pendulum":
        env = kernel_env(PendulumDx.default(device="cpu"))
    else:
        env = kernel_env(NNDynamics.init(3, 1, hidden=(16, 16), device="cpu", generator=torch.Generator().manual_seed(0)))
    scan = ROLLOUT_LANE_SCAN_MS[(case, T)]
    picks = [rollout_lanes(B, env, 132, T) for B in sorted(scan)]
    for B, lanes in zip(sorted(scan), picks):
        ms = dict(zip(ROLLOUT_LANES, scan[B]))
        assert lanes in ROLLOUT_LANES
        assert ms[lanes] <= 1.1 * min(ms.values()), (B, lanes, ms)
    assert picks == sorted(picks, reverse=True)


def test_dispatch_runs_the_plain_version_on_cpu():
    args, lo, hi = linear_case(True, seed=300)
    t = tensors(*args)
    lo_t, hi_t = tensors(lo, hi)
    before = linesearch_rollout_cuda.launches
    got = lqr_linesearch_rollout(*t, u_lower=lo_t, u_upper=hi_t)
    want = linesearch_rollout_plain(*t, u_lower=lo_t, u_upper=hi_t)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert linesearch_rollout_cuda.launches == before
    with pytest.raises(ValueError, match="use_cuda=True"):
        lqr_linesearch_rollout(*t, use_cuda=True)
    # float64 in, float64 out, and the line search computes in float64:
    # within float32 rounding of the float32 one, and not that one cast
    got64 = linesearch_rollout_plain(*(a.double() for a in t), u_lower=lo_t.double(), u_upper=hi_t.double())
    assert got64.us.dtype == torch.float64 and got64.improved.dtype == torch.bool
    np.testing.assert_allclose(got64.us.numpy(), got.us.numpy(), atol=1e-6)
    assert not torch.equal(got64.objs, got.objs.double())


def test_staging_rejects_what_the_kernel_does_not_take():
    args, lo, hi = linear_case(True, seed=301)
    t = tensors(*args)

    def never(*_):
        raise AssertionError("launched")

    class OtherEnv:
        def kernel_params(self):
            return torch.zeros(3)

    with pytest.raises(TypeError, match="float32"):
        run_staged_rollout(never, t[0].double(), *t[1:])
    with pytest.raises(ValueError, match="x_hat must be"):
        run_staged_rollout(never, *t[:7], t[7][:, :, :2], t[8])
    with pytest.raises(ValueError, match="both set"):
        run_staged_rollout(never, *t, u_lower=torch.tensor(-1.0))
    with pytest.raises(NotImplementedError,
                       match="PendulumDx, CartpoleDx, VehicleDx, QuadrotorDx, AcrobotDx and NNDynamics only"):
        run_staged_rollout(never, *t, dyn=OtherEnv())
    # a fusable MLP off the prebuilt architecture table stages and launches:
    # its kernels are a variant built at first use, not a raise
    odd = NNDynamics.init(3, 2, hidden=(5,), device="cpu", generator=torch.Generator().manual_seed(0))
    assert env_variant_key(kernel_env(odd), "rollout") == VariantKey("rollout", 3, 2, "nn", (5,))
    seen = []
    run_staged_rollout(lambda args, n, m, env: seen.append((n, m, env is not None)), *t, dyn=odd)
    assert seen == [(3, 2, True)]
    pend, _, _, jdx = pendulum_case()
    with pytest.raises(ValueError, match="n=3, m=1"):
        run_staged_rollout(never, *t, dyn=convert.pendulum_from_jax(jdx, device="cpu"))


def test_lqr_rollout_matches_jax():
    args, lo, hi = linear_case(True, seed=302)
    x_init, _, _, F, f, K, k, x_hat, u_hat = args
    rng = np.random.default_rng(303)
    alpha = jnp.asarray(rng.uniform(0.1, 1.0, B), jnp.float32)
    want = jax_lqr_rollout(x_init, F, f, K, k, x_hat, u_hat, alpha=alpha, u_lower=lo, u_upper=hi, delta_u=0.4)
    tx, tF, tf, tK, tk, txh, tuh, ta, tlo, thi = tensors(x_init, F, f, K, k, x_hat, u_hat, alpha, lo, hi)
    got = lqr_rollout(tx, tF, tf, tK, tk, txh, tuh, alpha=ta, u_lower=tlo, u_upper=thi, delta_u=0.4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    plain = jax_lqr_rollout(x_init, F, None, K, k)  # zero references, f = 0
    for g, w in zip(lqr_rollout(tx, tF, None, tK, tk), plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
