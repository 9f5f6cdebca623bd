"""The PyTorch port's PendulumDx against the JAX package's, on the same inputs.

The inputs sit on the edges the solver relies on: controls exactly on the
torque bound +-2 and past it, speeds past the +-8 clamp and exactly on it.
Tolerances: 1e-6 in float32 (the same op sequence; sin/cos differ by an ulp
between the two CPU backends), 1e-12 in float64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffmpc_tpu.models import PendulumDx as JaxPendulumDx  # noqa: E402
from diffmpc_tpu_torch.models import PendulumDx  # noqa: E402

B = 64


def _inputs(dtype):
    """States and controls as numpy arrays of ``dtype``: random ones, plus
    controls on and past the torque bound, speeds past the speed clamp, and
    a state whose next speed lands exactly on +8 (x = (1, 0, 8), u = 0)."""
    rng = np.random.default_rng(1234)
    th = rng.uniform(-np.pi, np.pi, B)
    thdot = rng.uniform(-10.0, 10.0, B)
    thdot[:8] = [9.0, -9.0, 8.5, -8.5, 8.0, -8.0, 12.0, -12.0]
    x = np.stack([np.cos(th), np.sin(th), thdot], -1)
    x[8] = [1.0, 0.0, 8.0]
    x[9] = [1.0, 0.0, -8.0]
    u = rng.uniform(-3.0, 3.0, (B, 1))
    u[8:10] = 0.0
    u[10:20:2] = 2.0
    u[11:21:2] = -2.0
    u[21], u[22] = 2.5, -2.5
    return x.astype(dtype), u.astype(dtype)


def _both(dtype, batched=False):
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    jdtype = {torch.float32: jnp.float32, torch.float64: jnp.float64}[dtype]
    x, u = _inputs(np_dtype)
    params = np.array([10.0, 1.0, 1.0], np_dtype)
    if batched:
        rng = np.random.default_rng(99)
        params = (params * rng.uniform(0.9, 1.1, (B, 3))).astype(np_dtype)
    jdx = JaxPendulumDx(params=jnp.asarray(params, jdtype))
    tdx = PendulumDx(params=torch.tensor(params, dtype=dtype))
    jx, ju = jnp.asarray(x, jdtype), jnp.asarray(u, jdtype)
    tx, tu = torch.tensor(x, dtype=dtype), torch.tensor(u, dtype=dtype)
    return jdx, tdx, (jx, ju), (tx, tu)


def _tol(dtype):
    return 1e-6 if dtype == torch.float32 else 1e-12


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_forward_matches_jax(dtype, batched):
    jdx, tdx, (jx, ju), (tx, tu) = _both(dtype, batched)
    want = np.asarray(jdx.forward(jx, ju))
    got = tdx.forward(tx, tu).numpy()
    np.testing.assert_allclose(got, want, rtol=_tol(dtype), atol=_tol(dtype))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_grad_input_matches_jax(dtype, batched):
    jdx, tdx, (jx, ju), (tx, tu) = _both(dtype, batched)
    A_j, B_j = jdx.grad_input(jx, ju)
    A_t, B_t = tdx.grad_input(tx, tu)
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), rtol=_tol(dtype), atol=_tol(dtype))
    np.testing.assert_allclose(B_t.numpy(), np.asarray(B_j), rtol=_tol(dtype), atol=_tol(dtype))


def _entries(jdx, tdx, jxu, txu, batched):
    """Entry lists and kernel params of both packages."""
    (jx, ju), (tx, tu) = jxu, txu
    jp, tp = jdx.kernel_params(), tdx.kernel_params()
    jparams = [jp[..., j] for j in range(3)] if batched else [jp[j] for j in range(3)]
    tparams = list(tp.t()) if batched else list(tp)
    return (
        jparams, [jx[:, i] for i in range(3)], [ju[:, 0]],
        tparams, list(tx.t()), [tu[:, 0]],
    )


@pytest.mark.parametrize("batched", [False, True])
def test_entries_step_matches_jax(batched):
    jdx, tdx, jxu, txu = _both(torch.float32, batched)
    jp, jxe, jue, tp, txe, tue = _entries(jdx, tdx, jxu, txu, batched)
    want = jdx.entries_step(jp, jxe, jue)
    got = tdx.entries_step(tp, txe, tue)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    # and the rotation-identity step agrees with the atan2 forward
    fwd = tdx.forward(*txu)
    np.testing.assert_allclose(torch.stack(got, -1).numpy(), fwd.numpy(), atol=1e-5)


@pytest.mark.parametrize("batched", [False, True])
def test_entries_step_jvp_matches_jax(batched):
    """Every Jacobian column of entries_step by forward mode: torch.func.jvp
    against jax.jvp. On the bounds the tangent passes (bclamp)."""
    jdx, tdx, jxu, txu = _both(torch.float32, batched)
    jp, jxe, jue, tp, txe, tue = _entries(jdx, tdx, jxu, txu, batched)

    def jstep(*tau):
        return jdx.entries_step(jp, list(tau[:3]), list(tau[3:]))

    def tstep(*tau):
        return tuple(tdx.entries_step(tp, list(tau[:3]), list(tau[3:])))

    for j in range(4):
        jseed = tuple(jnp.full(B, 1.0 if a == j else 0.0, jnp.float32) for a in range(4))
        tseed = tuple(torch.full((B,), 1.0 if a == j else 0.0) for a in range(4))
        _, want = jax.jvp(jstep, tuple(jxe + jue), jseed)
        _, got = torch.func.jvp(tstep, tuple(txe + tue), tseed)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    # the control column is non-zero exactly on the torque bound
    _, (_, _, dthdot) = torch.func.jvp(
        tstep, tuple(txe + tue), tuple(torch.full((B,), float(a == 3)) for a in range(4))
    )
    on_bound = (txu[1][:, 0].abs() == 2.0) & (dthdot != 0)
    assert int(on_bound.sum()) >= 8


def test_batch_helpers_match_jax():
    """bmv, bquad, bdot and the two clamps against diffmpc_tpu.utils.batch;
    bclamp's tangent is 1 exactly on the bound, as jnp.where gives it."""
    from diffmpc_tpu.utils import batch as jb
    from diffmpc_tpu_torch.utils import batch as tb

    rng = np.random.default_rng(7)
    M, v = rng.normal(size=(5, 4, 4)), rng.normal(size=(5, 4))
    tM, tv = torch.tensor(M), torch.tensor(v)
    np.testing.assert_allclose(tb.bmv(tM, tv).numpy(), np.asarray(jb.bmv(M, v)), rtol=1e-12)
    np.testing.assert_allclose(tb.bquad(tv, tM).numpy(), np.asarray(jb.bquad(v, M)), rtol=1e-12)
    np.testing.assert_allclose(tb.bdot(tv, tv).numpy(), np.asarray(jb.bdot(v, v)), rtol=1e-12)
    x = np.array([-3.0, -2.0, -1.0, 0.0, 2.0, 2.5])
    tx = torch.tensor(x)
    np.testing.assert_array_equal(tb.eclamp(tx, -2.0, None).numpy(), np.asarray(jb.eclamp(x, -2.0, None)))
    np.testing.assert_array_equal(tb.eclamp(tx, -2.0, 2.0).numpy(), np.asarray(jb.eclamp(x, -2.0, 2.0)))
    _, want = jax.jvp(lambda a: jb.bclamp(a, -2.0, 2.0), (x,), (np.ones_like(x),))
    _, got = torch.func.jvp(lambda a: tb.bclamp(a, -2.0, 2.0), (tx,), (torch.ones_like(tx),))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [0.0, 1.0, 1.0, 1.0, 1.0, 0.0])
    leaf = tx.clone().requires_grad_(True)
    assert not tb.detach(leaf * 2).requires_grad


def test_get_true_obj_and_default_match_jax():
    jdx = JaxPendulumDx.default(jnp.float32)
    tdx = PendulumDx.default(device="cpu")
    np.testing.assert_array_equal(tdx.params.numpy(), np.asarray(jdx.params))
    for j, t in zip(jdx.get_true_obj(), tdx.get_true_obj()):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tdx.param_batch_shape == () and jdx.param_batch_shape == ()
    tb = tdx.replace(params=tdx.params.expand(5, 3))
    assert tb.param_batch_shape == (5,)
