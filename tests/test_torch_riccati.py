"""The port's Riccati sweep (kernel A's plain version) and its box QP against
the JAX package's, on the same inputs.

- ``riccati_backward_plain`` against the JAX Pallas kernel
  ``riccati_backward_pallas`` in interpret mode (the recipe of
  tests/test_pallas_riccati.py: T=5, B=64) in its three modes at
  (n, m) in {(3,1), (3,2), (4,2)}: ``K, k`` within
  ``1e-5 * max(1, max|JAX|)`` (both compute in float32 in the same entry
  order; the rest is summation rounding), ``free`` and ``n_qp`` equal; and
  against the XLA ``riccati_backward`` within 1e-4 in free and mask modes.
  In box mode the bound is 5e-4, the JAX package's own between its kernel
  and XLA (tests/test_pallas_riccati.py): a box QP whose clamped dim has a
  gradient within the 1e-6 validity tolerance of zero may resolve to a
  neighbouring candidate in the matrix form. The JAX kernel and XLA differ by
  2.7e-4 on one such ``k`` entry of the (3, 2) case, and so does the port;
- the m = 2 box QP in entry form against JAX's matrix-form ``_pnqp_enum``,
  the port's ``ops/pnqp.py`` and ``tests/oracles.py::boxqp_enumerate`` on
  corner-heavy QPs, and the m = 3 projected-Newton loop against JAX's
  ``_pnqp_entries``;
- ``ops/smallchol.py`` and ``ops/pnqp.py`` against their JAX twins;
- the simplified value update: ``value_update_exact_reg=1e-6`` on the plain
  version against the JAX kernel traced with its ``VALUE_UPDATE_EXACT_REG``
  set to 1e-6, at the tolerance above; its gate (a ``reg`` above the
  threshold, or the m = 3 box QP's loop, keeps the full form bit for bit);
- the Riccati kernels' lane rule's picks.
"""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffmpc_tpu.ops import smallchol as jsc  # noqa: E402
from diffmpc_tpu.ops.lqr import riccati_backward as jax_riccati  # noqa: E402
from diffmpc_tpu.ops.pallas import riccati as jric  # noqa: E402
from diffmpc_tpu_torch.ops import smallchol as tsc  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.riccati import (  # noqa: E402
    BOX,
    FREE,
    MASK,
    riccati_backward_cuda,
    riccati_backward_plain,
    riccati_lanes,
    run_staged_riccati,
)
from diffmpc_tpu_torch.ops.cuda.riccati_entries import _pnqp_entries  # noqa: E402
from diffmpc_tpu_torch.ops.lqr import riccati_backward  # noqa: E402
from oracles import boxqp_enumerate, random_lqr_problem  # noqa: E402

# the module, which diffmpc_tpu.ops shadows with its pnqp function
jax_pnqp_mod = importlib.import_module("diffmpc_tpu.ops.pnqp")
tpnqp = importlib.import_module("diffmpc_tpu_torch.ops.pnqp")  # likewise diffmpc_tpu_torch.ops

T, B = 5, 64
MODES = ("free", "box", "mask")


@functools.partial(jax.jit, static_argnames=("n", "pallas"))
def jax_sweep(C, c, F, f, lo, hi, u_hat, mask, *, n, pallas):
    """JAX's sweep in the mode the given arrays select (None: unused)."""
    fn = functools.partial(jric.riccati_backward_pallas, interpret=True) if pallas else jax_riccati
    return fn(C, c, F, f, n, u_lower=lo, u_upper=hi, u_hat=u_hat, ctrl_mask=mask, pnqp_iter=8)


def sweep_inputs(n, m, mode, seed=0):
    """The recipe of tests/test_pallas_riccati.py as numpy float32, with a
    random u_hat in box mode so that the delta-u box is not symmetric."""
    rng = np.random.default_rng(700 + 10 * n + m + seed)
    C, c, F, f, _ = (a.astype(np.float32) for a in random_lqr_problem(rng, T, B, n, m))
    kw = dict(lo=None, hi=None, u_hat=None, mask=None)
    if mode == "box":
        kw.update(
            lo=np.full((T, B, m), -0.5, np.float32), hi=np.full((T, B, m), 0.5, np.float32),
            u_hat=rng.uniform(-0.3, 0.3, (T, B, m)).astype(np.float32),
        )
    elif mode == "mask":
        kw["mask"] = rng.random((T, B, m)) < 0.3
    return (C, c, F, f), kw


def torch_kw(kw):
    names = dict(lo="u_lower", hi="u_upper", u_hat="u_hat", mask="ctrl_mask")
    return {names[k]: torch.tensor(v) for k, v in kw.items() if v is not None}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,m", [(3, 1), (3, 2), (4, 2)])
def test_plain_matches_jax_pallas_kernel(n, m, mode):
    arrays, kw = sweep_inputs(n, m, mode)
    jargs = [jnp.asarray(a) for a in arrays] + [None if v is None else jnp.asarray(v) for v in kw.values()]
    want = jax_sweep(*jargs, n=n, pallas=True)
    xla = jax_sweep(*jargs, n=n, pallas=False)
    got = riccati_backward_plain(*map(torch.tensor, arrays), n, **torch_kw(kw))
    for name in ("K", "k"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.dtype == np.float32, name
        np.testing.assert_allclose(g, w, atol=1e-5 * max(1.0, np.abs(w).max()), rtol=0, err_msg=name)
        xla_tol = 5e-4 if mode == "box" else 1e-4
        np.testing.assert_allclose(g, np.asarray(getattr(xla, name)), atol=xla_tol, rtol=0, err_msg=name)
    np.testing.assert_array_equal(got.free_mask.numpy(), np.asarray(want.free_mask))
    np.testing.assert_array_equal(got.n_qp_iter.numpy(), np.asarray(want.n_qp_iter))
    if mode == "box":
        assert not got.free_mask.all()  # the box binds somewhere
    if mode == "mask":
        np.testing.assert_array_equal(got.free_mask.numpy(), ~kw["mask"])


def test_dispatch_runs_the_plain_version_on_cpu_and_casts_back():
    arrays, kw = sweep_inputs(3, 2, "box", seed=1)
    t = [torch.tensor(a) for a in arrays]
    before = riccati_backward_cuda.launches
    got = riccati_backward(*t, 3, **torch_kw(kw), pnqp_iter=8)
    want = riccati_backward_plain(*t, 3, **torch_kw(kw))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert riccati_backward_cuda.launches == before  # nothing was launched
    with pytest.raises(ValueError, match="use_cuda=True"):
        riccati_backward(*t, 3, use_cuda=True)
    with pytest.raises(ValueError, match="use_cuda=True"):
        riccati_backward_cuda(*t, 3)
    got64 = riccati_backward_plain(*(a.double() for a in t), 3, **{k: v.double() if v.is_floating_point() else v for k, v in torch_kw(kw).items()})
    assert got64.K.dtype == torch.float64 and got64.free_mask.dtype == torch.bool
    assert got64.n_qp_iter.dtype == torch.int32
    # computed in float64: within float32 rounding of the float32 sweep, and
    # not that sweep cast
    np.testing.assert_allclose(got64.K.numpy(), want.K.numpy(), atol=1e-6)
    assert not torch.equal(got64.K, want.K.double())


def test_staging_rejects_what_the_kernel_does_not_take():
    arrays, kw = sweep_inputs(3, 2, "mask", seed=2)
    C, c, F, f = (torch.tensor(a) for a in arrays)
    mask = torch.tensor(kw["mask"])

    def never(*_):
        raise AssertionError("launched")

    with pytest.raises(TypeError, match="float32"):
        run_staged_riccati(never, C.double(), c, F, f, 3, ctrl_mask=mask)
    with pytest.raises(TypeError, match="bool"):
        run_staged_riccati(never, C, c, F, f, 3, ctrl_mask=mask.float())
    with pytest.raises(ValueError, match="F must be"):
        run_staged_riccati(never, C, c, F[..., :4], f, 3, ctrl_mask=mask)
    with pytest.raises(ValueError, match="box mode"):
        run_staged_riccati(never, C, c, F, f, 3, u_lower=c[..., 3:], u_upper=c[..., 3:])


# ---------------------------------------------------------------------------
# The box QP.
# ---------------------------------------------------------------------------


def corner_heavy_qps(rng, n_qp, m):
    """Box QPs whose optima sit on corners and edges: a strong linear term
    against a narrow, off-centre box (tests/test_pnqp.py's recipe, pushed
    to the bounds), plus exact ties on the bound."""
    L = rng.standard_normal((n_qp, m, m))
    H = np.einsum("bij,bkj->bik", L, L) / m + 0.5 * np.eye(m)
    q = rng.standard_normal((n_qp, m)) * 4.0
    centre = rng.uniform(-0.3, 0.3, (n_qp, m))
    width = rng.uniform(0.05, 0.6, (n_qp, m))
    lo, hi = centre - width, centre + width
    q[: n_qp // 8] = 0.0  # interior optima at the origin, free where it is inside
    return H, q, lo, hi


def entries(H, q, lo, hi):
    m = q.shape[-1]
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return (
        [[t(H[:, i, j]) for j in range(m)] for i in range(m)],
        [t(q[:, i]) for i in range(m)], [t(lo[:, i]) for i in range(m)], [t(hi[:, i]) for i in range(m)],
    )


@functools.partial(jax.jit, static_argnames=("m",))
def jax_entries_qp(H, q, lo, hi, *, m):
    ent = (
        [[H[:, i, j] for j in range(m)] for i in range(m)],
        [q[:, i] for i in range(m)], [lo[:, i] for i in range(m)], [hi[:, i] for i in range(m)],
    )
    x, frozen, n_qp = jric._pnqp_entries(*ent, m, 8, 1e-9)
    return jnp.stack(x, -1), jnp.stack(frozen, -1), n_qp


@jax.jit
def jax_matrix_enum(H, q, lo, hi):
    return jax_pnqp_mod._pnqp_enum(H, q, lo, hi, 1e-9, 1e-6)


def test_two_control_box_qp_matches_the_matrix_forms_and_the_oracle():
    rng = np.random.default_rng(31)
    H, q, lo, hi = corner_heavy_qps(rng, 512, 2)
    x, frozen, n_qp = _pnqp_entries(*entries(H, q, lo, hi), 2, 8, 1e-9)
    x = torch.stack(x, -1).numpy()
    frozen = torch.stack(frozen, -1).numpy()
    assert bool((n_qp == 1).all())
    h32 = [a.astype(np.float32) for a in (H, q, lo, hi)]
    jx, jfrozen, _ = jax_entries_qp(*map(jnp.asarray, h32), m=2)
    np.testing.assert_allclose(x, np.asarray(jx), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(frozen, np.asarray(jfrozen))
    mat = jax_matrix_enum(*map(jnp.asarray, h32))
    ours = tpnqp.pnqp(*map(torch.tensor, h32))
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(mat.x), atol=1e-6, rtol=0)
    np.testing.assert_allclose(x, ours.x.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ours.free_mask.numpy(), np.asarray(mat.free_mask))
    np.testing.assert_allclose(x, boxqp_enumerate(H, q, lo, hi), atol=1e-5, rtol=0)
    # corner-heavy: both dims clamped for many QPs, and interior ones too
    assert (frozen.sum(-1) == 2).mean() > 0.2 and (frozen.sum(-1) == 0).mean() > 0.05


def test_three_control_loop_matches_jax_entries():
    rng = np.random.default_rng(32)
    H, q, lo, hi = corner_heavy_qps(rng, 256, 3)
    x, frozen, n_qp = _pnqp_entries(*entries(H, q, lo, hi), 3, 8, 1e-9)
    h32 = [jnp.asarray(a, jnp.float32) for a in (H, q, lo, hi)]
    jx, jfrozen, jn = jax_entries_qp(*h32, m=3)
    np.testing.assert_allclose(torch.stack(x, -1).numpy(), np.asarray(jx), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(torch.stack(frozen, -1).numpy(), np.asarray(jfrozen))
    np.testing.assert_array_equal(n_qp.numpy(), np.asarray(jn))
    assert float(n_qp.max()) > 1  # the loop iterates


@pytest.mark.parametrize("m", [1, 3])
def test_matrix_pnqp_matches_jax(m):
    rng = np.random.default_rng(40 + m)
    H, q, lo, hi = corner_heavy_qps(rng, 64, m)
    want = jax_pnqp_mod.pnqp(*map(jnp.asarray, (H, q, lo, hi)))
    got = tpnqp.pnqp(*map(torch.tensor, (H, q, lo, hi)))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-9)
    np.testing.assert_allclose(got.chol_free.numpy(), np.asarray(want.chol_free), atol=1e-9)
    np.testing.assert_array_equal(got.free_mask.numpy(), np.asarray(want.free_mask))
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(want.n_iter))
    np.testing.assert_allclose(got.x.numpy(), boxqp_enumerate(H, q, lo, hi), atol=1e-6)


def test_smallchol_matches_jax():
    rng = np.random.default_rng(41)
    for m in (1, 2, 4):
        L = rng.standard_normal((8, m, m))
        A = np.einsum("bij,bkj->bik", L, L) + 0.5 * np.eye(m)
        b = rng.standard_normal((8, m, 3))
        chol = tsc.cholesky_small(torch.tensor(A), 1e-3)
        np.testing.assert_allclose(chol.numpy(), np.asarray(jsc.cholesky_small(jnp.asarray(A), 1e-3)), atol=1e-12)
        x = tsc.cho_solve_small(chol, torch.tensor(b))
        np.testing.assert_allclose(x.numpy(), np.linalg.solve(A + 1e-3 * np.eye(m), b), atol=1e-10)
    mask = torch.tensor([[True, False, False, True]])
    Hm = tpnqp.masked_identity_system(torch.tensor(A[:1]), mask, 1e-9)
    np.testing.assert_allclose(
        Hm.numpy(), np.asarray(jax_pnqp_mod.masked_identity_system(jnp.asarray(A[:1]), jnp.asarray(mask.numpy()), 1e-9))
    )


@pytest.mark.parametrize("mode", MODES)
def test_plain_returns_the_box_qp_it_solved(mode):
    """``return_qp``: each step's control block of Q, by which the card's
    checks weigh two answers of the box QP. At t = T-1 it is C's own block;
    in free mode k solves it; the result is the same as without the flag."""
    n, m = 4, 2
    (C, c, F, f), kw = sweep_inputs(n, m, mode)
    args = (torch.tensor(C), torch.tensor(c), torch.tensor(F), torch.tensor(f), n)
    res, Quu, qu = riccati_backward_plain(*args, return_qp=True, **torch_kw(kw))
    assert Quu.shape == (T, B, m, m) and qu.shape == (T, B, m)
    for a, b in zip(res, riccati_backward_plain(*args, **torch_kw(kw))):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(Quu[-1].numpy(), C[-1, :, n:, n:])
    np.testing.assert_array_equal(qu[-1].numpy(), c[-1, :, n:])
    if mode == "free":
        k = -torch.linalg.solve(Quu.double(), qu.double())
        np.testing.assert_allclose(res.k.numpy(), k.numpy(), atol=1e-5 * max(1.0, float(k.abs().max())))


@pytest.mark.parametrize("n,m,mode", [(4, 2, "box"), (3, 2, "free"), (3, 1, "mask"), (3, 1, "box")])
def test_simplified_value_update_matches_jax_pallas_kernel(monkeypatch, n, m, mode):
    """``value_update_exact_reg=1e-6`` against the JAX kernel traced with
    ``VALUE_UPDATE_EXACT_REG = 1e-6`` (a jit of its own, so that it traces
    with the patched threshold): ``K, k`` within ``1e-5 * max(1, max|JAX|)``,
    ``free`` and ``n_qp`` equal; and the update engaged, the gains part
    from the full form's."""
    monkeypatch.setattr(jric, "VALUE_UPDATE_EXACT_REG", 1e-6)
    arrays, kw = sweep_inputs(n, m, mode, seed=3)
    kernel = jax.jit(functools.partial(jric.riccati_backward_pallas, pnqp_iter=8, interpret=True), static_argnums=4)
    names = dict(lo="u_lower", hi="u_upper", u_hat="u_hat", mask="ctrl_mask")
    want = kernel(*map(jnp.asarray, arrays), n, **{names[k]: jnp.asarray(v) for k, v in kw.items() if v is not None})
    got = riccati_backward_plain(*map(torch.tensor, arrays), n, value_update_exact_reg=1e-6, **torch_kw(kw))
    for name in ("K", "k"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_allclose(g, w, atol=1e-5 * max(1.0, np.abs(w).max()), rtol=0, err_msg=name)
    np.testing.assert_array_equal(got.free_mask.numpy(), np.asarray(want.free_mask))
    np.testing.assert_array_equal(got.n_qp_iter.numpy(), np.asarray(want.n_qp_iter))
    full = riccati_backward_plain(*map(torch.tensor, arrays), n, **torch_kw(kw))
    assert not torch.equal(got.K, full.K)


def test_simplified_value_update_gate():
    """The simplified form engages only where the JAX package's gate lets it:
    ``reg`` above ``value_update_exact_reg`` and the m = 3 box QP (the
    projected-Newton loop, not exact) keep the full form bit for bit."""
    arrays, kw = sweep_inputs(3, 2, "box", seed=4)
    t = [torch.tensor(a) for a in arrays]
    full = riccati_backward_plain(*t, 3, reg=1e-5, **torch_kw(kw))
    above = riccati_backward_plain(*t, 3, reg=1e-5, value_update_exact_reg=1e-6, **torch_kw(kw))
    assert all(torch.equal(a, b) for a, b in zip(full, above))
    rng = np.random.default_rng(5)
    C, c, F, f, _ = (torch.tensor(a, dtype=torch.float32) for a in random_lqr_problem(rng, T, B, 3, 3))
    box = dict(u_lower=torch.tensor(-0.5), u_upper=torch.tensor(0.5), u_hat=torch.zeros(T, B, 3))
    loop = riccati_backward_plain(C, c, F, f, 3, value_update_exact_reg=1e-6, **box)
    assert all(torch.equal(a, b) for a, b in zip(loop, riccati_backward_plain(C, c, F, f, 3, **box)))


def test_riccati_lane_rule_picks():
    """The Riccati kernels' lane rule at the shapes it was measured at (132
    SMs): config 2 (n=4, m=2, box) at B = 128 and 4096 takes 16 lanes, at
    16,384 and on a full card (65,536) one lane; the pendulum's box step
    (n=3, m=1) one lane; free and mask modes 16 lanes at B=1000. (Whether
    one lane stages is the launcher's choice: test_torch_cuda.py,
    test_riccati_launcher_stages_while_a_wave_holds_the_batch.)"""
    for B, T, want in ((128, 20, 16), (128, 128, 16), (4096, 20, 16), (4096, 128, 16), (16384, 20, 1), (65536, 128, 1)):
        assert riccati_lanes(B, 4, 2, BOX, 132, T) == want, (B, T)
    assert riccati_lanes(1024, 3, 1, BOX, 132, 20) == riccati_lanes(1024, 3, 1, BOX, 132, 256) == 1
    assert riccati_lanes(1000, 3, 2, FREE, 132, 20) == riccati_lanes(1000, 3, 2, MASK, 132, 20) == 16
