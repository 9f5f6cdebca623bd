"""The box QP's enumeration modes and the simplified value update, the port
against the JAX package.

The JAX package keeps both behind module globals: ``DIFFMPC_PNQP_ENUM``
(``_PNQP_ENUM`` in ``diffmpc_tpu/ops/pallas/riccati.py``, read at trace
time) and ``VALUE_UPDATE_EXACT_REG``. Each JAX function here is jitted once
per setting at module level, the global set while it traces (the way
``tests/test_value_update.py`` monkeypatches them); the port takes the same
settings as the keywords ``pnqp_enum`` and ``value_update_exact_reg``.

Tolerances: the box QP within 5e-6 (``test_value_update.py:84-99``), its
frozen mask and solve count equal; sweeps and one-iteration solves within
1e-4; the exactness gate equal to ``_pnqp_is_exact`` and
``_use_exact_value_update`` everywhere.
"""

import contextlib
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from diffmpc_tpu.models import NNDynamics as JaxNN  # noqa: E402
from diffmpc_tpu.models import PendulumDx as JaxPendulumDx  # noqa: E402
from diffmpc_tpu.ops.pallas import riccati as jric  # noqa: E402
from diffmpc_tpu.ops.pallas.ilqr import ilqr_solve_fused as jax_ilqr  # noqa: E402
from diffmpc_tpu.ops.pallas.kkt import kkt_backward_fused as jax_kkt  # noqa: E402
from diffmpc_tpu_torch import MPCConfig, convert  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.ilqr import fused_exact_update, ilqr_solve_fused, ilqr_solve_plain  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.kkt import kkt_backward_plain, kkt_exact_update  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.riccati import BOX, FREE, MASK, riccati_backward_plain, use_exact_value_update  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.riccati_entries import _pnqp_entries, pnqp_enum_flag  # noqa: E402
from oracles import random_lqr_problem  # noqa: E402
from torch_parity import as_numpy, assert_tight, kernel_inputs, make_problem, random_residuals, torch_inputs  # noqa: E402

# the module, which diffmpc_tpu.ops shadows with its pnqp function
jax_pnqp_mod = importlib.import_module("diffmpc_tpu.ops.pnqp")
tpnqp = importlib.import_module("diffmpc_tpu_torch.ops.pnqp")  # likewise diffmpc_tpu_torch.ops

MODES = ("", "0", "1")


@pytest.fixture(autouse=True)
def _no_env_knob(monkeypatch):
    """A live DIFFMPC_PNQP_ENUM would override the JAX module global."""
    monkeypatch.delenv("DIFFMPC_PNQP_ENUM", raising=False)


@contextlib.contextmanager
def jax_knobs(mode="", exact_reg=-1.0):
    """The JAX package's two globals set while a function traces."""
    old = jric._PNQP_ENUM, jric.VALUE_UPDATE_EXACT_REG
    jric._PNQP_ENUM, jric.VALUE_UPDATE_EXACT_REG = mode, exact_reg
    try:
        yield
    finally:
        jric._PNQP_ENUM, jric.VALUE_UPDATE_EXACT_REG = old


def traced_under(fn, mode="", exact_reg=-1.0):
    """``jax.jit(fn)``, its first call (the trace) under the knobs."""
    jitted = jax.jit(fn)

    def call(*args):
        with jax_knobs(mode, exact_reg):
            return jitted(*args)

    return call


# ---------------------------------------------------------------------------
# The box QP.
# ---------------------------------------------------------------------------


def box_qps(rng, n_qp, m):
    """Box QPs with optima inside, on faces and in corners: a strong linear
    term against a narrow, off-centre box."""
    L = rng.standard_normal((n_qp, m, m))
    H = np.einsum("bij,bkj->bik", L, L) / m + 0.5 * np.eye(m)
    q = rng.standard_normal((n_qp, m)) * 4.0
    centre = rng.uniform(-0.3, 0.3, (n_qp, m))
    width = rng.uniform(0.05, 0.6, (n_qp, m))
    q[: n_qp // 8] = 0.0
    return [a.astype(np.float32) for a in (H, q, centre - width, centre + width)]


def qp_entries(H, q, lo, hi, xp):
    m = q.shape[-1]
    return (
        [[xp(H[:, i, j]) for j in range(m)] for i in range(m)],
        [xp(q[:, i]) for i in range(m)], [xp(lo[:, i]) for i in range(m)], [xp(hi[:, i]) for i in range(m)],
    )


@functools.lru_cache(maxsize=None)
def jax_entries_qp(mode, m):
    def fn(H, q, lo, hi):
        x, frozen, n_qp = jric._pnqp_entries(*qp_entries(H, q, lo, hi, lambda a: a), m, 8, 1e-9)
        return jnp.stack(x, -1), jnp.stack(frozen, -1), n_qp

    return traced_under(fn, mode)


@functools.lru_cache(maxsize=None)
def jax_matrix_qp(mode):
    return traced_under(lambda H, q, lo, hi: jax_pnqp_mod.pnqp(H, q, lo, hi, n_iter=20), mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m", [2, 3])
def test_pnqp_entries_modes_match_jax(m, mode):
    """Each mode's dispatch at m = 2 and 3 (the enumeration, or the loop of
    8 steps), entry by entry; the solve count says which ran."""
    H, q, lo, hi = box_qps(np.random.default_rng(1600 + 10 * m + len(mode) + (mode == "1")), 384, m)
    x, frozen, n_qp = _pnqp_entries(*qp_entries(H, q, lo, hi, torch.tensor), m, 8, 1e-9, mode)
    jx, jfrozen, jn = jax_entries_qp(mode, m)(*map(jnp.asarray, (H, q, lo, hi)))
    np.testing.assert_allclose(torch.stack(x, -1).numpy(), np.asarray(jx), atol=5e-6, rtol=0)
    np.testing.assert_array_equal(torch.stack(frozen, -1).numpy(), np.asarray(jfrozen))
    np.testing.assert_array_equal(n_qp.numpy(), np.asarray(jn))
    enumerates = (m == 2 and mode != "0") or (m == 3 and mode == "1")
    assert bool((n_qp == 1).all()) == enumerates


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m", [2, 3])
def test_matrix_pnqp_modes_match_jax(m, mode):
    H, q, lo, hi = box_qps(np.random.default_rng(1700 + 10 * m + MODES.index(mode)), 96, m)
    want = jax_matrix_qp(mode)(*map(jnp.asarray, (H, q, lo, hi)))
    got = tpnqp.pnqp(*map(torch.tensor, (H, q, lo, hi)), n_iter=20, pnqp_enum=mode)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=5e-6, rtol=0)
    np.testing.assert_array_equal(got.free_mask.numpy(), np.asarray(want.free_mask))
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(want.n_iter))


def test_unknown_mode_raises():
    H, q, lo, hi = box_qps(np.random.default_rng(1800), 8, 2)
    with pytest.raises(ValueError, match="pnqp_enum"):
        _pnqp_entries(*qp_entries(H, q, lo, hi, torch.tensor), 2, 8, 1e-9, "2")
    with pytest.raises(ValueError, match="pnqp_enum"):
        tpnqp.pnqp(*map(torch.tensor, (H, q, lo, hi)), pnqp_enum="yes")
    with pytest.raises(ValueError, match="pnqp_enum"):
        MPCConfig(n_state=4, n_ctrl=2, T=5, pnqp_enum="2")
    with pytest.raises(ValueError, match="pnqp_enum"):
        use_exact_value_update(BOX, 1, 1e-9, 1e-6, "x")


# ---------------------------------------------------------------------------
# The exactness gate.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_exactness_gate_matches_jax(mode):
    """``use_exact_value_update`` is ``_pnqp_is_exact`` and ``reg <=
    threshold`` in every mode and at every m; among them, m = 2 in box mode
    under "0" keeps the full form, and m = 3 under "1" takes the
    simplified one. The kernels' flag changes only where the mode changes the
    QP."""
    names = {FREE: "free", BOX: "box", MASK: "mask"}
    for threshold in (-1.0, 1e-6):
        with jax_knobs(mode, threshold):
            for kind, name in names.items():
                for m in (1, 2, 3, 4):
                    for reg in (1e-9, 1e-5):
                        want = jric._use_exact_value_update(name, m, reg)
                        assert use_exact_value_update(kind, m, reg, threshold, mode) == want, (name, m, reg)
                        assert jric._pnqp_is_exact(name, m) == use_exact_value_update(kind, m, 0.0, 1.0, mode)
                    assert fused_exact_update(m, 1e-9, threshold, mode) == jric._use_exact_value_update("box", m, 1e-9)
                assert kkt_exact_update(1e-7, threshold) == jric._use_exact_value_update("mask", 2, 1e-7)
    assert use_exact_value_update(BOX, 2, 1e-9, 1e-6, "0") is False
    assert use_exact_value_update(BOX, 3, 1e-9, 1e-6, "1") is True
    flags = {(m, md): pnqp_enum_flag(m, md) for m in (1, 2, 3, 4) for md in MODES}
    assert {k: v for k, v in flags.items() if v} == {(2, "0"): 1, (3, "1"): 2}


# ---------------------------------------------------------------------------
# The Riccati sweep at (6, 3) and (4, 2), box mode, against the JAX kernel.
# ---------------------------------------------------------------------------

ST, SB = 5, 64


def sweep_problem(n, m, seed):
    rng = np.random.default_rng(seed)
    C, c, F, f, _ = (a.astype(np.float32) for a in random_lqr_problem(rng, ST, SB, n, m))
    box = dict(u_lower=np.full((ST, SB, m), -0.5, np.float32), u_upper=np.full((ST, SB, m), 0.5, np.float32),
               u_hat=rng.uniform(-0.3, 0.3, (ST, SB, m)).astype(np.float32))
    return (C, c, F, f), box


@functools.lru_cache(maxsize=None)
def jax_sweep(n, mode, exact_reg):
    kernel = functools.partial(jric.riccati_backward_pallas, pnqp_iter=8, interpret=True)
    return traced_under(lambda C, c, F, f, lo, hi, uh: kernel(C, c, F, f, n, u_lower=lo, u_upper=hi, u_hat=uh),
                        mode, exact_reg)


def assert_sweep_matches(got, want, Quu, qu, tol=1e-4):
    """``K, k`` within ``tol * max(1, max|JAX|)``, ``free`` and ``n_qp``
    equal, on every scenario but those whose first departure in sweep order
    (t = T-1 down) is a tie of the box QP: both answers within 1e-5 of the
    QP's scale on its objective (in float64 on the port's QP), where an ulp
    of Q decides between two candidates (chip_smoke.py's
    riccati_agreement). Ties may take at most a tenth of the scenarios."""
    K, k, free = (getattr(got, f).numpy() for f in ("K", "k", "free_mask"))
    wK, wk, wfree = (np.asarray(getattr(want, f)) for f in ("K", "k", "free_mask"))
    bad = (np.abs(K - wK) > tol * max(1.0, np.abs(wK).max())).any((2, 3))
    bad |= (np.abs(k - wk) > tol * max(1.0, np.abs(wk).max())).any(2)
    bad |= (free != wfree).any(2) | (got.n_qp_iter.numpy() != np.asarray(want.n_qp_iter))
    ties = np.flatnonzero(bad.any(0))
    assert len(ties) <= 0.1 * bad.shape[1], ties
    for b in ties:
        t = np.flatnonzero(bad[:, b]).max()
        H, g = Quu[t, b].double(), qu[t, b].double()

        def obj(x):
            x = torch.tensor(x, dtype=torch.float64)
            return float(0.5 * x @ H @ x + g @ x)

        scale = max(1.0, abs(obj(k[t, b])))
        assert abs(obj(k[t, b]) - obj(wk[t, b])) <= 1e-5 * scale, (t, b, k[t, b], wk[t, b])


@pytest.mark.parametrize("n,m,mode,exact_reg", [
    (6, 3, "", -1.0), (6, 3, "1", -1.0), (6, 3, "1", 1e-6), (4, 2, "0", -1.0), (4, 2, "0", 1e-6),
])
def test_plain_sweep_modes_match_jax_kernel(n, m, mode, exact_reg):
    """The plain sweep against the JAX kernel by :func:`assert_sweep_matches`;
    with the threshold set, the simplified update engages at (6, 3) under
    "1" and not at (4, 2) under "0"."""
    arrays, box = sweep_problem(n, m, 1900 + 10 * n + MODES.index(mode))
    want = jax_sweep(n, mode, exact_reg)(*map(jnp.asarray, (*arrays, box["u_lower"], box["u_upper"], box["u_hat"])))
    kw = dict(pnqp_iter=8, pnqp_enum=mode, value_update_exact_reg=exact_reg, **{k: torch.tensor(v) for k, v in box.items()})
    got, Quu, qu = riccati_backward_plain(*map(torch.tensor, arrays), n, return_qp=True, **kw)
    assert_sweep_matches(got, want, Quu, qu)
    assert not got.free_mask.all()
    full = riccati_backward_plain(*map(torch.tensor, arrays), n, **dict(kw, value_update_exact_reg=-1.0))
    assert torch.equal(got.K, full.K) == (exact_reg < 0 or mode == "0")


# ---------------------------------------------------------------------------
# The fused solve: the (6, 3) MLP under each mode, pnqp_iter, and the
# simplified update on the pendulum.
# ---------------------------------------------------------------------------

FB, FT = 16, 6


@functools.lru_cache(maxsize=None)
def mlp_problem():
    """scripts/ab_pnqp_enum3.py:36-55's problem at B=16, T=6: the n = 6,
    m = 3 residual 16-16 MLP of PRNGKey(0), C = diag(1 x 6, 0.02 x 3),
    c = (0 x 6, 0.08 x 3), x0 ~ U(-0.8, 0.8) from seed 1, box +-0.5."""
    n, m = 6, 3
    nn = JaxNN.init(jax.random.PRNGKey(0), n, m, hidden=(16, 16), residual=True)
    assert nn.kernel_fusable
    rng = np.random.default_rng(1)
    prob = dict(
        x_init=rng.uniform(-0.8, 0.8, (FB, n)).astype(np.float32),
        C=np.ascontiguousarray(np.broadcast_to(np.diag([1.0] * n + [0.02] * m).astype(np.float32), (FT, FB, 9, 9))),
        c=np.ascontiguousarray(np.broadcast_to(np.array([0.0] * n + [0.08] * m, np.float32), (FT, FB, 9))),
        u_lower=np.full((FT, FB, m), -0.5, np.float32),
        u_upper=np.full((FT, FB, m), 0.5, np.float32),
    )
    return nn, prob


@functools.lru_cache(maxsize=None)
def jax_mlp_solve(mode, pnqp_iter):
    nn, prob = mlp_problem()
    solve = traced_under(lambda x, C, c, lo, hi: jax_ilqr(x, C, c, nn, lo, hi, lqr_iter=1, eps=0.0,
                                                           pnqp_iter=pnqp_iter, interpret=True), mode)
    out = solve(*(jnp.asarray(prob[k]) for k in ("x_init", "C", "c", "u_lower", "u_upper")))
    return {f: np.asarray(getattr(out, f)) for f in out._fields}


def port_mlp_args():
    nn, prob = mlp_problem()
    t = {k: torch.tensor(v) for k, v in prob.items()}
    return t["x_init"], t["C"], t["c"], convert.nn_dynamics_from_jax(nn, device="cpu"), t["u_lower"], t["u_upper"]


def assert_one_iteration(got, want):
    """torch_parity.assert_tight's 1e-4 budget, the objectives' relative to
    their scale: the MLP's run to ~100, where float32 holds ~1e-5."""
    scale = max(1.0, float(np.abs(want["objs"]).max()))
    for f, w in want.items():
        g = got[f]
        if f == "last_improvement":  # +inf where nothing ran
            g, w = np.where(np.isinf(g), 0, g), np.where(np.isinf(w), 0, w)
        tol = 1e-4 * (scale if f in ("objs", "last_improvement") else 1.0)
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), atol=tol, rtol=0, err_msg=f)
    np.testing.assert_array_equal(got["n_iters"], want["n_iters"])


@pytest.mark.parametrize("mode,pnqp_iter", [("1", 8), ("0", 2)])
def test_plain_fused_mlp_solve_modes_match_jax_kernel(mode, pnqp_iter):
    """One iteration of the (6, 3) MLP's fused solve against the JAX kernel
    in interpret mode (:func:`assert_one_iteration`): the 27-candidate
    enumeration under "1"; the loop under "0" (at m = 3 the QP of "" too),
    with ``pnqp_iter`` honoured. Its QPs converge within 5 steps, so 5 and 8
    solve alike; 2 binds, and parts from 8."""
    args = port_mlp_args()
    got = ilqr_solve_fused(*args, lqr_iter=1, eps=0.0, pnqp_iter=pnqp_iter, pnqp_enum=mode)
    assert_one_iteration(as_numpy(got), jax_mlp_solve(mode, pnqp_iter))
    assert (float(got.qp_iters.max()) == 1.0) == (mode == "1")
    if mode == "0":
        for other in ("", "0"):
            same = ilqr_solve_plain(*args, lqr_iter=1, eps=0.0, pnqp_iter=8, pnqp_enum=other)
            five = ilqr_solve_plain(*args, lqr_iter=1, eps=0.0, pnqp_iter=5, pnqp_enum=other)
            assert all(torch.equal(a, b) for a, b in zip(same, five))
        assert not torch.equal(got.qp_iters, same.qp_iters) and not torch.equal(got.us, same.us)


@functools.lru_cache(maxsize=None)
def jax_pendulum_solve(exact_reg):
    prob = make_problem(seed=1950, warm=True)
    solve = traced_under(lambda x, C, c, lo, hi, p, ui: jax_ilqr(x, C, c, JaxPendulumDx(params=p), lo, hi, u_init=ui,
                                                                  lqr_iter=1, eps=0.0, interpret=True),
                         "", exact_reg)
    out = solve(*(jnp.asarray(prob[k]) for k in ("x_init", "C", "c", "u_lower", "u_upper", "params", "u_init")))
    return {f: np.asarray(getattr(out, f)) for f in out._fields}


def test_plain_fused_simplified_update_matches_jax_kernel():
    """``value_update_exact_reg=1e-6`` in the fused solve (the pendulum,
    m = 1, whose closed-form QP is exact) against the JAX kernel traced with
    ``VALUE_UPDATE_EXACT_REG = 1e-6`` (``test_value_update.py:245-247``),
    one iteration within 1e-4; the update engaged, the solve parts from the
    full form's."""
    t, dx = torch_inputs(make_problem(seed=1950, warm=True))
    args = (t["x_init"], t["C"], t["c"], dx, t["u_lower"], t["u_upper"])
    got = ilqr_solve_fused(*args, u_init=t["u_init"], lqr_iter=1, eps=0.0, value_update_exact_reg=1e-6)
    assert_tight(as_numpy(got), jax_pendulum_solve(1e-6))
    full = ilqr_solve_plain(*args, u_init=t["u_init"], lqr_iter=1, eps=0.0)
    assert not torch.equal(got.us, full.us)


@functools.lru_cache(maxsize=None)
def jax_kkt_exact(n, m):
    return traced_under(lambda *ins: jax_kkt(*ins, reg=1e-7, interpret=True), "", 1e-6)


@pytest.mark.parametrize("n,m", [(3, 1), (6, 3)])
def test_plain_kkt_simplified_update_matches_jax_kernel(n, m):
    """The KKT backward's auxiliary sweep (mask mode: always exact) with the
    simplified update against the JAX kernel traced with
    ``VALUE_UPDATE_EXACT_REG = 1e-6``, within 1e-4 of each output's scale;
    the update engaged."""
    res = random_residuals(np.random.default_rng(1960 + n), 6, 24, n, m, 24)
    ins = kernel_inputs(res)
    want = jax_kkt_exact(n, m)(*map(jnp.asarray, ins))
    t = [torch.tensor(a) for a in ins]
    got = kkt_backward_plain(*t, reg=1e-7, value_update_exact_reg=1e-6)
    for name, g, w in zip(("dx_init", "dC", "dc", "dF", "df"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * max(1.0, np.abs(w).max()), rtol=0, err_msg=name)
    full = kkt_backward_plain(*t, reg=1e-7)
    assert not torch.equal(got[0], full[0])
