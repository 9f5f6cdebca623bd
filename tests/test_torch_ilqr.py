"""The port's fused iLQR solve (plain PyTorch version) against the JAX
package's Pallas kernel in interpret mode, on the same inputs.

Tolerances: after one iteration (``lqr_iter=1, eps=0``) every output within
1e-4 abs and ``n_iters`` equal. Over several iterations swing-up iLQR is
chaotic, so f32-level differences can move a scenario to another iteration
count (CLAUDE.md "Invariants"): ``n_iters`` equal on >= 90% of scenarios,
objectives within 1e-3 on those, and controls within 5e-3 on those whose
last line-search step agrees; see ``assert_chaos`` in tests/torch_parity.py
for the converged ties.
The per-step helpers are compared with the JAX package's entry-tile helpers
at 1e-5 relative.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from diffmpc_tpu.models import PendulumDx as JaxPendulumDx  # noqa: E402
from diffmpc_tpu.ops.pallas import riccati as jric  # noqa: E402
from diffmpc_tpu.ops.pallas.ilqr import ilqr_solve_fused as jax_ilqr  # noqa: E402
from diffmpc_tpu_torch.ops.cuda import riccati_entries as tric  # noqa: E402
from diffmpc_tpu_torch.models import NNDynamics  # noqa: E402
from diffmpc_tpu_torch.models import PendulumDx  # noqa: E402
from diffmpc_tpu_torch.csrc.build import VariantKey  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.ilqr import (  # noqa: E402
    ILQR_LANES,
    _NNEnv,
    env_variant_key,
    ilqr_lanes,
    ilqr_solve_fused,
    ilqr_solve_plain,
    kernel_env,
    run_staged,
)
from torch_parity import (  # noqa: E402
    B,
    T,
    assert_chaos,
    assert_tight,
    make_problem,
    solve_plain,
    torch_inputs,
)


def solve_jax(prob, **knobs):
    j = {k: None if v is None else jnp.asarray(v, jnp.float32) for k, v in prob.items()}
    dx = JaxPendulumDx(params=j["params"])
    out = jax_ilqr(
        j["x_init"], j["C"], j["c"], dx, j["u_lower"], j["u_upper"],
        u_init=j["u_init"], interpret=True, **knobs,
    )
    return {f: np.asarray(getattr(out, f)) for f in out._fields}


VARIANTS = {
    "cold": (dict(), dict()),
    "warm": (dict(warm=True), dict()),
    "delta_u": (dict(), dict(delta_u=0.5)),
    "batched_params": (dict(batched_params=True), dict()),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_one_iteration_matches_jax(variant):
    prob_kw, knobs = VARIANTS[variant]
    prob = make_problem(**prob_kw)
    knobs = dict(knobs, lqr_iter=1, eps=0.0)
    assert_tight(solve_plain(prob, **knobs), solve_jax(prob, **knobs))


@pytest.mark.parametrize("variant", ["cold", "all_knobs"])
def test_four_iterations_match_jax_chaos_rule(variant):
    if variant == "cold":
        prob, knobs = make_problem(), {}
    else:
        prob = make_problem(seed=701, batched_params=True, warm=True)
        knobs = dict(delta_u=0.5)
    knobs = dict(knobs, lqr_iter=4, eps=1e-5)
    got, want = solve_plain(prob, **knobs), solve_jax(prob, **knobs)
    assert_chaos(got, want)
    # the solve did something: most scenarios improved on the first rollout
    assert (got["n_iters"] >= 2).mean() > 0.5


def test_unroll_matches_jax_unroll():
    """``unroll=True`` (the exact-power ladder ``alpha = decay**k``,
    ilqr.py:336-348) against the JAX kernel's ``unroll=True`` in interpret
    mode, on the recipe of tests/test_pallas_ilqr.py:604-645 (B=16, T=8,
    swing-up starts from seed 5, ``lqr_iter=4``, ``eps=1e-5``): one iteration
    within 1e-4, four by the chaos rule, and every chosen alpha one of the
    float32-rounded powers on both sides. The recipe's picks are the full
    step and the ladder's floor; a pick where the powers part from the
    rolled ladder's products (k >= 2) is held in
    tests/test_torch_kernel_host.py."""
    prob = make_problem(seed=5, B=16, T=8)
    one = dict(lqr_iter=1, eps=0.0, unroll=True)
    assert_tight(solve_plain(prob, **one), solve_jax(prob, **one))
    four = dict(lqr_iter=4, eps=1e-5, unroll=True)
    got, want = solve_plain(prob, **four), solve_jax(prob, **four)
    assert_chaos(got, want)
    powers = np.float32([0.2**k for k in range(10)])
    assert np.isin(got["alpha"], powers).all() and np.isin(want["alpha"], powers).all()


# The fused kernel alone at each built lane count, ms at L = 1 / 2 / 4 / 16
# (CUDA events, interleaved, best of rounds): the lane A/B's scan,
# diffmpc_tpu_torch.diagnostics.ab_ilqr_lanes, on an NVIDIA H100 80GB HBM3 at
# 700 W (132 SMs); the pendulum at T=20, lqr_iter=10, the 3-16-16-3 MLP at
# T=15, lqr_iter=8 (PERF.md, rows 1-1b).
LANE_SCAN_MS = {
    ("pendulum", False): {
        1024: (1.96, 1.301, 0.888, 0.518),
        2048: (1.97, 1.31, 0.892, 0.661),
        4096: (2.017, 1.326, 0.892, 0.935),
        8192: (2.03, 1.344, 1.121, 1.924),
        16384: (2.168, 1.632, 1.706, 3.272),
        32768: (4.326, 3.141, 3.417, 6.134),
        65536: (6.943, 6.279, 7.023, 12.117),
    },
    ("pendulum", True): {
        1024: (2.186, 1.517, 0.901, 0.474),
        2048: (2.178, 1.55, 0.894, 0.571),
        4096: (2.19, 1.543, 0.895, 0.784),
        8192: (2.236, 1.55, 1.116, 1.329),
        16384: (2.822, 2.167, 1.753, 2.691),
        32768: (5.172, 4.026, 3.689, 5.634),
        65536: (7.999, 8.048, 8.184, 11.686),
    },
    ("mlp_3_16_16_3", False): {
        1024: (8.117, 4.695, 3.232, 1.866),
        2048: (8.178, 4.73, 3.287, 2.532),
        4096: (8.283, 4.722, 3.304, 5.957),
        8192: (8.173, 4.875, 4.205, 9.35),
        16384: (8.27, 6.099, 9.733, 17.676),
        32768: (10.975, 14.029, 15.069, 33.693),
        65536: (15.493, 21.778, 28.78, 66.548),
    },
    ("mlp_3_16_16_3", True): {
        1024: (8.135, 4.276, 2.586, 1.006),
        2048: (8.165, 4.28, 2.652, 1.229),
        4096: (8.224, 4.273, 2.652, 1.878),
        8192: (8.232, 4.527, 3.255, 3.613),
        16384: (8.54, 5.568, 5.034, 7.104),
        32768: (11.216, 8.488, 9.856, 13.955),
        65536: (16.107, 16.701, 19.338, 27.732),
    },
}


# The fused variants' kernel alone (the shared sweep) on an NVIDIA H100
# 80GB HBM3 at 700 W, ms at L = 1, 2, 4, 16 (diagnostics/ab_ilqr_lanes.py
# --variants --wide, PR 21; 16,384 and 65,536 from one call, the rest from
# another): each env's example problem (the wraps': the slewed receding
# loop's first solve) at its width and at 4096 to 65,536; B=1 the render
# example's one robot at env step 40.
VARIANT_LANE_SCAN_MS = {
    "cartpole": {1: (0.4799, 0.3818, 0.2982, 0.1335), 4096: (2.8506, 1.9202, 1.3291, 0.9829),
                 8192: (3.0083, 1.9931, 2.07, 2.0102), 16384: (5.2697, 3.1303, 3.5604, 3.9512),
                 65536: (13.7077, 12.4386, 14.8425, 15.1443)},
    "vehicle": {1: (0.4078, 0.3641, 0.2833, 0.1543), 1024: (2.5312, 2.1281, 1.537, 0.7068),
                4096: (2.664, 2.1534, 1.5928, 1.1812), 8192: (3.4003, 2.4505, 2.1737, 2.2927),
                16384: (4.5553, 3.2682, 3.697, 4.6614), 65536: (11.0598, 11.2749, 14.0068, 18.8572)},
    "quadrotor": {1: (0.2275, 0.2635, 0.209, 0.1014), 1024: (2.782, 3.0617, 2.3291, 1.0269),
                  4096: (2.6017, 2.7211, 2.0286, 1.6517), 8192: (4.1566, 3.5788, 3.2088, 3.4212),
                  16384: (4.9737, 4.7697, 6.7203, 6.8944), 65536: (15.1264, 21.7973, 27.9748, 27.891)},
    "acrobot": {1: (0.4314, 0.6492, 0.4901, 0.2121), 1024: (1.5738, 2.2537, 1.6757, 0.7152),
                4096: (1.6556, 2.2975, 1.6849, 1.6378), 8192: (2.3958, 2.4286, 2.0451, 2.7308),
                16384: (2.8401, 2.8989, 4.2809, 5.3272), 65536: (9.0822, 9.9613, 14.2398, 20.8183)},
    "passthrough_vehicle": {1024: (2.6305, 2.7877, 2.1775, 1.1566), 4096: (2.8569, 2.7321, 2.1529, 2.0073),
                            8192: (3.8661, 3.2523, 2.9557, 4.0663), 16384: (4.5071, 4.2714, 6.0038, 8.2597),
                            65536: (13.5203, 18.813, 24.4589, 33.9533)},
    "passthrough_pendulum": {1024: (2.0915, 1.5636, 1.0265, 0.4969), 4096: (2.1471, 1.5539, 1.0287, 1.1872),
                             8192: (2.2332, 1.6217, 1.4207, 1.906), 16384: (3.4834, 2.3641, 2.4716, 3.6349),
                             65536: (9.5223, 9.3624, 10.026, 13.4722)},
}


def _assert_picks_the_fastest(picks: list, scan: dict) -> None:
    """Each pick, in the batch order of ``scan``, a built lane count within
    10% of the fastest one's time there and within 3% of one lane's; never
    more lanes as the batch grows."""
    for B, lanes in zip(sorted(scan), picks):
        ms = dict(zip(ILQR_LANES, scan[B]))
        assert lanes in ILQR_LANES
        assert ms[lanes] <= 1.1 * min(ms.values()), (B, lanes, ms)
        assert ms[lanes] <= 1.03 * ms[1], (B, lanes, ms)
    assert picks == sorted(picks, reverse=True)


@pytest.mark.parametrize("hoist_lin", [False, True], ids=["in_sweep", "hoist_lin"])
@pytest.mark.parametrize("env", ["pendulum", "mlp_3_16_16_3"])
def test_lane_rule_picks_the_fastest_measured_lane_count(env, hoist_lin):
    """``ilqr_lanes`` on a 132-SM card: at each batch of the measured scan
    (``LANE_SCAN_MS``) it picks a built lane count whose time is within 10%
    of the fastest one's there and within 3% of one lane's; never more lanes
    as the batch grows."""
    if env == "pendulum":
        dyn = PendulumDx.default(device="cpu")
    else:
        dyn = NNDynamics.init(3, 1, hidden=(16, 16), device="cpu", generator=torch.Generator().manual_seed(0))
    scan = LANE_SCAN_MS[(env, hoist_lin)]
    _assert_picks_the_fastest([ilqr_lanes(B, kernel_env(dyn), 132, hoist_lin) for B in sorted(scan)], scan)


@pytest.mark.parametrize("env", list(VARIANT_LANE_SCAN_MS))
def test_variant_lane_rule_picks_the_fastest_measured_lane_count(env):
    """The same for the fused variants (the shared sweep at 16 lanes) on
    their measured scan (``VARIANT_LANE_SCAN_MS``), each a model without
    prebuilt launchers, so that the rule takes it as a variant."""
    from diffmpc_tpu_torch.diagnostics.ab_ilqr_lanes import case_model

    env_k = kernel_env(case_model(env)[0])
    assert env_k.symbol is None
    scan = VARIANT_LANE_SCAN_MS[env]
    _assert_picks_the_fastest([ilqr_lanes(B, env_k, 132) for B in sorted(scan)], scan)


def test_wrapper_takes_plain_version_on_cpu():
    prob = make_problem()
    t, dx = torch_inputs(prob)
    args = (t["x_init"], t["C"], t["c"], dx, t["u_lower"], t["u_upper"])
    before = ilqr_solve_fused.launches
    a = ilqr_solve_fused(*args, lqr_iter=2, use_cuda=None)
    b = ilqr_solve_plain(*args, lqr_iter=2)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert ilqr_solve_fused.launches == before  # nothing was launched
    with pytest.raises(ValueError, match="use_cuda=True"):
        ilqr_solve_fused(*args, use_cuda=True)
    # float64 in, float64 out, and the solve computes in float64: within
    # float32 rounding of the float32 solve, and not that solve cast
    a64 = ilqr_solve_fused(
        t["x_init"].double(), t["C"].double(), t["c"].double(), dx,
        t["u_lower"].double(), t["u_upper"].double(), lqr_iter=2,
    )
    assert a64.us.dtype == torch.float64 and a64.n_iters.dtype == torch.int32
    np.testing.assert_allclose(a64.us.numpy(), b.us.numpy(), atol=1e-6)
    assert not torch.equal(a64.objs, b.objs.double())


def test_kernel_staging_rejects_what_the_kernel_does_not_take():
    prob = make_problem()
    t, dx = torch_inputs(prob)
    args = (t["x_init"], t["C"], t["c"], dx, t["u_lower"], t["u_upper"])

    def never(*_):
        raise AssertionError("launched")

    with pytest.raises(TypeError, match="float32"):
        run_staged(never, t["x_init"].double(), *args[1:])

    class OtherEnv:
        def kernel_params(self):
            return dx.params

    with pytest.raises(NotImplementedError,
                       match="PendulumDx, CartpoleDx, VehicleDx, QuadrotorDx, AcrobotDx and NNDynamics only"):
        run_staged(never, *args[:3], OtherEnv(), *args[4:])
    # an MLP: the instantiated architectures stage and launch, the others raise
    gen = torch.Generator().manual_seed(0)
    nn = NNDynamics.init(3, 1, hidden=(8,), device="cpu", generator=gen)
    seen = []
    run_staged(lambda a, e: seen.append(ctypes.cast(e, ctypes.POINTER(_NNEnv)).contents.activation), *args[:3], nn, *args[4:])
    assert seen == [1]  # tanh, the second of the activations
    with pytest.raises(ValueError, match="NNDynamics is n=3, m=2"):
        run_staged(never, *args[:3], NNDynamics.init(3, 2, hidden=(8,), device="cpu", generator=gen), *args[4:])
    # an architecture outside the prebuilt table stages and launches too: its
    # kernels are a variant built at first use (kernel_library), not a raise
    odd = NNDynamics.init(3, 1, hidden=(12,), residual=True, device="cpu", generator=gen)
    assert kernel_env(odd).symbol is None
    assert env_variant_key(kernel_env(odd), "ilqr") == VariantKey("ilqr", 3, 1, "nn", (12,))
    seen.clear()
    run_staged(lambda a, e: seen.append(ctypes.cast(e, ctypes.POINTER(_NNEnv)).contents.residual), *args[:3], odd,
               *args[4:])
    assert seen == [1]
    with pytest.raises(ValueError, match="params"):
        run_staged(never, *args[:3], dx.replace(params=dx.params[None].expand(7, 3)), *args[4:])
    with pytest.raises(ValueError, match="c must be"):
        run_staged(never, args[0], args[1], args[2][:, :5], *args[3:])
    # m = 2: the box QP takes it now, the kernel's pendulum step does not
    C5 = torch.zeros(T, B, 5, 5)
    with pytest.raises(ValueError, match="n=3, m=1"):
        run_staged(never, args[0], C5, torch.zeros(T, B, 5), dx, torch.zeros(T, B, 2), torch.ones(T, B, 2))


# ---- the per-step helpers against the JAX package's entry-tile helpers ----


def _rand_spd(rng, m, n_b=32):
    A = rng.normal(size=(n_b, m, m))
    return np.einsum("bij,bkj->bik", A, A) + m * np.eye(m)


def _split(a, jax_side):
    """(n_b, *shape) numpy -> nested lists of (n_b,) entries."""
    mk = (lambda v: jnp.asarray(v, jnp.float32)) if jax_side else (
        lambda v: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32))
    if a.ndim == 1:
        return mk(a)
    return [_split(a[:, i], jax_side) for i in range(a.shape[1])]


def _np(e):
    if isinstance(e, (list, tuple)):
        return np.stack([_np(v) for v in e], -1)
    return np.asarray(e) if not isinstance(e, torch.Tensor) else e.numpy()


@pytest.mark.parametrize("m", [1, 2, 3])
def test_chol_helpers_match_jax(m):
    rng = np.random.default_rng(m)
    A, b = _rand_spd(rng, m), rng.normal(size=(32, m))
    Lj = jric._chol_entries(_split(A, True), m, 1e-7)
    Lt = tric._chol_entries(_split(A, False), m, 1e-7)
    for i in range(m):
        for j in range(i + 1):
            np.testing.assert_allclose(_np(Lt[i][j]), _np(Lj[i][j]), rtol=1e-5, atol=1e-6)
    xj = jric._cho_solve_entries(Lj, _split(b, True), m)
    xt = tric._cho_solve_entries(Lt, _split(b, False), m)
    np.testing.assert_allclose(_np(xt), _np(xj), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m", [1, 2])
def test_masked_chol_solve_matches_jax(m):
    rng = np.random.default_rng(10 + m)
    Quu, rhs = _rand_spd(rng, m), rng.normal(size=(32, 3, m))
    frozen = (rng.uniform(size=(32, m)) < 0.4).astype(np.float64)
    want = jric._masked_chol_solve(
        _split(Quu, True), [_split(rhs[:, c], True) for c in range(3)], _split(frozen, True), m, 1e-7
    )
    got = tric._masked_chol_solve(
        _split(Quu, False), [_split(rhs[:, c], False) for c in range(3)], _split(frozen, False), m, 1e-7
    )
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


def test_box_qp_closed_form_matches_jax():
    rng = np.random.default_rng(20)
    n_b = 64
    Quu = rng.uniform(0.1, 2.0, (n_b, 1, 1))
    qu = rng.normal(size=(n_b, 1)) * 3
    lo, hi = np.full((n_b, 1), -1.0), np.full((n_b, 1), 1.0)
    qu[:4, 0] = Quu[:4, 0, 0] * np.array([1.0, -1.0, 1.0, -1.0])  # optimum on a bound
    args_j = (_split(Quu, True), _split(qu, True), _split(lo, True), _split(hi, True))
    args_t = (_split(Quu, False), _split(qu, False), _split(lo, False), _split(hi, False))
    xj, fj, nj = jric._pnqp_entries(*args_j, 1, 8, 1e-7)
    xt, ft, nt = tric._pnqp_entries(*args_t, 1, 8, 1e-7)
    np.testing.assert_allclose(_np(xt), _np(xj), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(_np(ft), _np(fj))
    np.testing.assert_array_equal(_np(nt), _np(nj))
    assert 0 < _np(ft).sum() < n_b
    # m = 2 is ported now: the active-set enumeration, against JAX's
    H2, q2 = _rand_spd(rng, 2, n_b), rng.normal(size=(n_b, 2)) * 3
    lo2, hi2 = np.full((n_b, 2), -0.5), np.full((n_b, 2), 0.5)
    xj, fj, nj = jric._pnqp_entries(*(_split(a, True) for a in (H2, q2, lo2, hi2)), 2, 8, 1e-7)
    xt, ft, nt = tric._pnqp_entries(*(_split(a, False) for a in (H2, q2, lo2, hi2)), 2, 8, 1e-7)
    np.testing.assert_allclose(_np(xt), _np(xj), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(_np(ft), _np(fj))
    np.testing.assert_array_equal(_np(nt), _np(nj))


@pytest.mark.parametrize("n,m", [(3, 1), (4, 2)])
def test_value_update_full_form_matches_jax(n, m):
    rng = np.random.default_rng(30 + n)
    nm = n + m
    Q = _rand_spd(rng, nm)
    q, K, kt = rng.normal(size=(32, nm)), rng.normal(size=(32, m, n)), rng.normal(size=(32, m))

    def side(j):
        Qe = _split(Q, j)
        Quu = [[Qe[n + a][n + b] for b in range(m)] for a in range(m)]
        qe = _split(q, j)
        return Qe, qe, Quu, qe[n:], _split(K, j), _split(kt, j)

    Vj, vj = jric._value_update(*side(True), n, m, False)
    Vt, vt = tric._value_update(*side(False), n, m)
    np.testing.assert_allclose(_np(Vt), _np(Vj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(vt), _np(vj), rtol=1e-5, atol=1e-5)
