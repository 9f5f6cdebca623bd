"""The long-horizon path's dispatch and the Riccati and KKT twins, against
the JAX package.

- ``ops/cuda/horizon.py`` gives the JAX package's answer, for every T in
  1..1024 and every ``(n, m)`` the kernels are built for, to "does this
  horizon take the streaming twin?": compared with the JAX package's own
  ``fits_vmem``, ``rollout_scratch_bytes`` and ``kkt_fits_vmem``, at the
  default budget and at a small one set on both sides.
- The Riccati twin's port entry on CPU tensors (its plain version,
  re-exported by ``ops/cuda/riccati_stream.py``) against the JAX twin
  ``riccati_backward_pallas_stream`` in interpret mode, in its three modes at
  (n, m) = (4, 2) and (3, 1), T=7, B=32: ``K, k`` within
  ``1e-4 * max(1, max|JAX|)`` (both compute in float32 in the same entry
  order; the rest is summation rounding) with ``free`` and ``n_qp`` equal,
  outside the box-QP ties that tests/test_torch_riccati.py describes (a
  scenario whose QP sits at a tie may take a neighbouring candidate; none
  occurs on these inputs, and the test counts them).
- The KKT twin's port entry (its plain version, re-exported by
  ``ops/cuda/kkt_stream.py``) against ``kkt_backward_fused_stream`` in
  interpret mode at (4, 2) and (3, 1), T=8, B=24: every output within
  ``1e-5 * max(1, max|JAX|)``.
- On CPU tensors the dispatchers run the plain versions whatever the horizon
  and launch nothing.
- The simplified value update through the dispatch (``ops/lqr.py``,
  ``value_update_exact_reg=1e-6``, the twin's horizon) against the JAX twin
  traced with its ``VALUE_UPDATE_EXACT_REG`` set to 1e-6: ``K`` and ``free``
  as above; ``k`` as above but for box-QP ties, which this update meets on
  these inputs (a control at its bound whose free solution lands on it too:
  the two sides take the two candidates, 1.9e-8 of the QP objective's scale
  apart). Each scenario's latest step off the tolerance must be such a tie,
  both answers within 1e-5 of the objective's scale on the plain version's
  QP (chip_smoke's rule for the kernels), and ties stay under 5% of the
  scenarios. ``K`` does not see a tie: it depends on the frozen mask and on
  ``V``, not on ``k``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffmpc_tpu.ops.pallas import kkt as jkkt  # noqa: E402
from diffmpc_tpu.ops.pallas import riccati as jric  # noqa: E402
from diffmpc_tpu.ops.pallas.kkt_stream import kkt_backward_fused_stream  # noqa: E402
from diffmpc_tpu.ops.pallas.riccati_stream import riccati_backward_pallas_stream  # noqa: E402
from diffmpc_tpu_torch.ops import lqr as tlqr  # noqa: E402
from diffmpc_tpu_torch.ops.cuda import horizon  # noqa: E402
from diffmpc_tpu_torch.ops.cuda import kkt_stream, riccati_stream  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.ilqr import KERNEL_SHAPES  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.kkt import kkt_backward_fused  # noqa: E402
from oracles import random_lqr_problem  # noqa: E402
from torch_parity import kernel_inputs, random_residuals  # noqa: E402

HORIZONS = range(1, 1025)


def jax_choice(T, n, m):
    """The JAX package's choice of twin for (Riccati, rollout, KKT)
    (ops/lqr_step.py:139, :211, :342-350)."""
    riccati_fits = jric.fits_vmem(T, n, m)
    return (
        not riccati_fits,
        not jric.fits_vmem(T, n, m, extra=jric.rollout_scratch_bytes(T, n, m)),
        not jkkt.kkt_fits_vmem(T, n, m) and not riccati_fits,
    )


def port_choice(T, n, m):
    return horizon.streams_riccati(T, n, m), horizon.streams_rollout(T, n, m), horizon.streams_kkt(T, n, m)


@pytest.mark.parametrize("n,m", KERNEL_SHAPES)
def test_horizon_dispatch_is_the_jax_packages(n, m):
    assert horizon.VMEM_BUDGET_BYTES == jric.VMEM_BUDGET_BYTES == 24 * 1024 * 1024
    assert horizon.TILE_B == jric.TILE_B
    for T in HORIZONS:
        assert port_choice(T, n, m) == jax_choice(T, n, m), T
        assert horizon.riccati_vmem_bytes(T, n, m) == jric.riccati_vmem_bytes(T, n, m)
        assert horizon.rollout_scratch_bytes(T, n, m) == jric.rollout_scratch_bytes(T, n, m)
    # each twin is taken from some horizon on, and kept beyond it
    for k in range(3):
        flags = [port_choice(T, n, m)[k] for T in HORIZONS]
        first = flags.index(True)
        assert first > 0 and all(flags[first:])


def test_horizon_thresholds_of_the_long_horizon_cells():
    """Box-DDP config 2 (n=4, m=2): the Riccati and KKT twins from T=72, the
    rollout twin from T=62; the pendulum (3, 1): from T=147 and T=121."""
    for (n, m), (t_ric, t_rol) in {(4, 2): (72, 62), (3, 1): (147, 121)}.items():
        assert not horizon.streams_riccati(t_ric - 1, n, m) and horizon.streams_riccati(t_ric, n, m)
        assert not horizon.streams_kkt(t_ric - 1, n, m) and horizon.streams_kkt(t_ric, n, m)
        assert not horizon.streams_rollout(t_rol - 1, n, m) and horizon.streams_rollout(t_rol, n, m)
    assert port_choice(128, 4, 2) == (True, True, True) and port_choice(20, 4, 2) == (False, False, False)


def test_a_small_budget_moves_both_packages_alike(monkeypatch):
    budget = 1 << 20
    monkeypatch.setattr(horizon, "VMEM_BUDGET_BYTES", budget)
    monkeypatch.setattr(jric, "VMEM_BUDGET_BYTES", budget)
    for n, m in KERNEL_SHAPES:
        for T in range(1, 65):
            assert port_choice(T, n, m) == jax_choice(T, n, m), (T, n, m)
    assert port_choice(12, 4, 2) == (True, True, True)


# ---------------------------------------------------------------------------
# The Riccati twin.
# ---------------------------------------------------------------------------

T, B = 7, 32


@functools.partial(jax.jit, static_argnames=("n",))
def jax_riccati_twin(C, c, F, f, lo, hi, u_hat, mask, *, n):
    return riccati_backward_pallas_stream(
        C, c, F, f, n, u_lower=lo, u_upper=hi, u_hat=u_hat, ctrl_mask=mask, pnqp_iter=8, interpret=True
    )


def riccati_inputs(n, m, mode):
    rng = np.random.default_rng(1700 + 10 * n + m)
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


@pytest.mark.parametrize("mode", ["free", "box", "mask"])
@pytest.mark.parametrize("n,m", [(4, 2), (3, 1)])
def test_riccati_twin_matches_jax_twin(n, m, mode):
    arrays, kw = riccati_inputs(n, m, mode)
    want = jax_riccati_twin(*map(jnp.asarray, arrays), *(None if v is None else jnp.asarray(v) for v in kw.values()), n=n)
    got = riccati_stream.riccati_backward_plain(*map(torch.tensor, arrays), n, **torch_kw(kw))
    free_equal = got.free_mask.numpy() == np.asarray(want.free_mask)
    ties = ~free_equal.all(-1)  # (T, B) steps where the box QP took another candidate
    assert ties.sum() == 0, f"{int(ties.sum())} box-QP ties"
    for name in ("K", "k"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.dtype == np.float32, name
        np.testing.assert_allclose(g, w, atol=1e-4 * max(1.0, np.abs(w).max()), rtol=0, err_msg=name)
    np.testing.assert_array_equal(got.n_qp_iter.numpy(), np.asarray(want.n_qp_iter))
    if mode == "box":
        assert not got.free_mask.all()  # the box binds somewhere


def test_riccati_dispatch_on_cpu_runs_the_plain_version_at_any_horizon(monkeypatch):
    monkeypatch.setattr(horizon, "VMEM_BUDGET_BYTES", 1 << 16)  # every T here takes the twin
    arrays, kw = riccati_inputs(4, 2, "box")
    t = [torch.tensor(a) for a in arrays]
    before = riccati_stream.riccati_backward_stream_cuda.launches
    got = tlqr.riccati_backward(*t, 4, **torch_kw(kw), pnqp_iter=8)
    want = riccati_stream.riccati_backward_plain(*t, 4, **torch_kw(kw))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert riccati_stream.riccati_backward_stream_cuda.launches == before
    with pytest.raises(ValueError, match="use_cuda=True"):
        riccati_stream.riccati_backward_stream_cuda(*t, 4)


@pytest.mark.parametrize("mode", ["box", "mask"])
def test_riccati_twin_simplified_value_update_matches_jax_twin(monkeypatch, mode):
    monkeypatch.setattr(jric, "VALUE_UPDATE_EXACT_REG", 1e-6)
    monkeypatch.setattr(horizon, "VMEM_BUDGET_BYTES", 1 << 16)  # every T here takes the twin
    arrays, kw = riccati_inputs(4, 2, mode)
    twin = jax.jit(functools.partial(riccati_backward_pallas_stream, pnqp_iter=8, interpret=True), static_argnums=4)
    names = dict(lo="u_lower", hi="u_upper", u_hat="u_hat", mask="ctrl_mask")
    want = twin(*map(jnp.asarray, arrays), 4, **{names[k]: jnp.asarray(v) for k, v in kw.items() if v is not None})
    got = tlqr.riccati_backward(*map(torch.tensor, arrays), 4, **torch_kw(kw), pnqp_iter=8, value_update_exact_reg=1e-6)
    assert bool((got.free_mask.numpy() == np.asarray(want.free_mask)).all())
    g, w = got.K.numpy(), np.asarray(want.K)
    np.testing.assert_allclose(g, w, atol=1e-4 * max(1.0, np.abs(w).max()), rtol=0, err_msg="K")
    k_got, k_want = got.k.double(), torch.tensor(np.asarray(want.k)).double()
    off = ((k_got - k_want).abs() > 1e-4 * max(1.0, float(k_want.abs().max()))).any(-1)  # (T, B) steps
    _, Quu, qu = riccati_stream.riccati_backward_plain(
        *map(torch.tensor, arrays), 4, **torch_kw(kw), value_update_exact_reg=1e-6, return_qp=True
    )
    for b in off.any(0).nonzero()[:, 0].tolist():
        t = int(off[:, b].nonzero().max())
        Q, q = Quu[t, b].double(), qu[t, b].double()
        j = [float(0.5 * k @ Q @ k + q @ k) for k in (k_got[t, b], k_want[t, b])]
        scale = float((0.5 * k_got[t, b, :, None] * Q * k_got[t, b, None, :]).abs().sum() + (q * k_got[t, b]).abs().sum())
        assert abs(j[0] - j[1]) <= 1e-5 * scale, (t, b, j, scale)
    assert int(off.any(0).sum()) <= 0.05 * off.shape[1]
    full = tlqr.riccati_backward(*map(torch.tensor, arrays), 4, **torch_kw(kw), pnqp_iter=8)
    assert not torch.equal(got.K, full.K)


# ---------------------------------------------------------------------------
# The KKT twin.
# ---------------------------------------------------------------------------


@jax.jit
def jax_kkt_twin(C, c, F, r, tau, tight):
    return kkt_backward_fused_stream(C, c, F, r, tau, tight, reg=1e-7, interpret=True)


@pytest.mark.parametrize("n,m,n_tight", [(4, 2, 60), (3, 1, 40)])
def test_kkt_twin_matches_jax_twin(n, m, n_tight):
    res = random_residuals(np.random.default_rng(1800 + 10 * n + m), 8, 24, n, m, n_tight)
    ins = kernel_inputs(res)
    assert ins[-1].any()
    want = jax_kkt_twin(*map(jnp.asarray, ins))
    got = kkt_stream.kkt_backward_plain(*map(torch.tensor, ins), reg=1e-7)
    for name, g, w in zip(("dx_init", "dC", "dc", "dF", "df"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * max(1.0, np.abs(w).max()), rtol=0, err_msg=name)
    # the dispatcher on CPU tensors: the plain version, nothing launched
    before = kkt_stream.kkt_backward_stream_cuda.launches, kkt_backward_fused.launches
    again = kkt_backward_fused(*map(torch.tensor, ins), reg=1e-7)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert (kkt_stream.kkt_backward_stream_cuda.launches, kkt_backward_fused.launches) == before
