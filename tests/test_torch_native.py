"""The port's engine against the float64 C++ oracle (``diffmpc_tpu_torch.native``),
as tests/test_native_oracle.py holds the JAX engine to the JAX package's
binding of the same source.

The oracle is first held to the dense-KKT solution (tests/oracles.py); then
the port's ``MPC`` on ``LinDx`` box-DDP problems, in float64 (every control
within 1e-7, the objectives within 1e-9: the two implementations share no
code) and in float32 (the parity budget, 2.5e-4 on the controls), and the
unconstrained problem against the dense KKT solve.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import diffmpc_tpu_torch as tdm  # noqa: E402
from diffmpc_tpu_torch import native  # noqa: E402
from oracles import dense_lqr_kkt, random_lqr_problem  # noqa: E402


def test_native_builds_into_the_port_and_loads():
    assert native._load() is not None
    assert native.BUILD_DIR.endswith("diffmpc_tpu_torch/_build/native")
    assert native.SOURCE.endswith("native/diffmpc_native.cpp")


def test_native_unconstrained_matches_dense_kkt():
    rng = np.random.default_rng(200)
    C, c, F, f, x_init = random_lqr_problem(rng, 8, 8, 3, 2)
    xs_o, us_o, _ = dense_lqr_kkt(C, c, F, f, x_init)
    xs, us, objs = native.solve_batch(*(torch.tensor(a) for a in (C, c, F, f, x_init)), ilqr_iter=5)
    assert xs.dtype == torch.float64 and objs.shape == (8,)
    np.testing.assert_allclose(us.numpy(), us_o, atol=1e-8)
    np.testing.assert_allclose(xs.numpy(), xs_o, atol=1e-8)


def test_native_refuses_a_tensor_off_the_host():
    C, c, F, f, x_init = (torch.tensor(a) for a in random_lqr_problem(np.random.default_rng(1), 3, 2, 2, 1))
    with pytest.raises(ValueError, match="host oracle"):
        native.solve_batch(C.to("meta"), c, F, f, x_init)


@pytest.mark.parametrize("m", [1, 2])
def test_port_engine_matches_native_box(m):
    rng = np.random.default_rng(201 + m)
    T, B, n = 15, 12, 4
    C, c, F, f, x_init = random_lqr_problem(rng, T, B, n, m)
    lo, hi = -0.5, 0.5
    xs_n, us_n, objs_n = native.solve_batch(C, c, F, f, x_init, u_lower=np.full((T, B, m), lo),
                                            u_upper=np.full((T, B, m), hi), ilqr_iter=100)
    ctrl = tdm.MPC(n, m, T, u_lower=lo, u_upper=hi, lqr_iter=100, exit_unconverged=False, eps=1e-13,
                   not_improved_lim=10 ** 6)
    for dtype, us_tol, obj_tol in ((torch.float64, 1e-7, 1e-9), (torch.float32, 2.5e-4, 1e-5)):
        t = [torch.tensor(a, dtype=dtype) for a in (C, c, F, f, x_init)]
        _, us, objs = ctrl(t[4], tdm.QuadCost(t[0], t[1]), tdm.LinDx(t[2], t[3]))
        np.testing.assert_allclose(us.numpy(), us_n.numpy(), atol=us_tol)
        np.testing.assert_allclose(objs.numpy(), objs_n.numpy(), rtol=obj_tol, atol=obj_tol)


def test_port_engine_unconstrained_matches_dense_kkt():
    rng = np.random.default_rng(204)
    C, c, F, f, x_init = random_lqr_problem(rng, 10, 6, 3, 2)
    _, us_o, _ = dense_lqr_kkt(C, c, F, f, x_init)
    t = [torch.tensor(a) for a in (C, c, F, f, x_init)]
    _, us, _ = tdm.MPC(3, 2, 10, lqr_iter=3, exit_unconverged=False)(t[4], tdm.QuadCost(t[0], t[1]),
                                                                   tdm.LinDx(t[2], t[3]))
    np.testing.assert_allclose(us.numpy(), us_o, atol=1e-8)
