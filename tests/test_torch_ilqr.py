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
from diffmpc_tpu_torch.ops.cuda.ilqr import (  # noqa: E402
    _NNEnv,
    ilqr_solve_fused,
    ilqr_solve_plain,
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

    with pytest.raises(NotImplementedError, match="PendulumDx and NNDynamics only"):
        run_staged(never, *args[:3], OtherEnv(), *args[4:])
    # an MLP: the instantiated architectures stage and launch, the others raise
    gen = torch.Generator().manual_seed(0)
    nn = NNDynamics.init(3, 1, hidden=(8,), device="cpu", generator=gen)
    seen = []
    run_staged(lambda a, e: seen.append(ctypes.cast(e, ctypes.POINTER(_NNEnv)).contents.activation), *args[:3], nn, *args[4:])
    assert seen == [1]  # tanh, the second of the activations
    with pytest.raises(ValueError, match="NNDynamics is n=3, m=2"):
        run_staged(never, *args[:3], NNDynamics.init(3, 2, hidden=(8,), device="cpu", generator=gen), *args[4:])
    odd = NNDynamics.init(3, 1, hidden=(12,), device="cpu", generator=gen)
    with pytest.raises(NotImplementedError, match=r"\(3, 1, \(16, 16\)\)"):
        run_staged(never, *args[:3], odd, *args[4:])
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
