"""The port's CPU solves in float64 against the JAX package's float64 goldens.

``tests/golden/pendulum_T20B16_f64.npz`` holds the controls and objectives
of the JAX package's float64 pendulum swing-up solve (the recipe of
tests/test_parity_golden.py:157-161 and :240-253: T=20, B=16, box +-2,
``lqr_iter=15``, ``eps=0``). The port's plain versions compute in the input
dtype, so its float64 solve holds the golden's own tolerances: controls
within 1e-4, objectives within 1e-5. Run on the fused path (the fused
solve's plain version, with and without the ``hoist_lin`` pre-pass) and on
the non-fused loop (``verbose=1``; and with ``AUTO_DIFF``, whose Jacobians
come from forward-mode autodiff of ``forward``).

The dynamics zoo's goldens (``cartpole_T20B16_f64``, ``vehicle_T20B16_f64``
with its asymmetric per-dimension box, ``quadrotor_T20B16_f64`` with the box
[0, 5], ``acrobot_T40B16_f64``; the recipes of
tests/test_parity_golden.py:164-215, tests/torch_zoo_cases.py) hold alike, on
the fused path and the non-fused loop.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import diffmpc_tpu_torch as tdm  # noqa: E402
from diffmpc_tpu_torch.models import PendulumDx  # noqa: E402
from torch_zoo_cases import GOLDENS, ZOO, golden_case, port_model  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "pendulum_T20B16_f64.npz")

VARIANTS = {
    "fused": dict(),
    "fused_hoist_lin": dict(hoist_lin=True),
    "non_fused": dict(verbose=1),
    "non_fused_auto_diff": dict(verbose=1, grad_method=tdm.GradMethods.AUTO_DIFF),
}


def _x_init():
    rng = np.random.default_rng(777)
    th = rng.uniform(-np.pi, np.pi, 16)
    return np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, 16)], -1)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_pendulum_float64_solve_holds_the_golden(variant, capsys):
    dx = PendulumDx.default(torch.float64, device="cpu")
    q, p = dx.get_true_obj()
    config = tdm.MPCConfig(
        n_state=3, n_ctrl=1, T=20, lqr_iter=15, eps=0.0, not_improved_lim=10**6,
        exit_unconverged=False, detach_unconverged=False,
    )
    config = dataclasses.replace(config, **VARIANTS[variant])
    sol = tdm.mpc_solve(
        config, torch.tensor(_x_init()), tdm.QuadCost(torch.diag(q), p), dx, u_lower=-2.0, u_upper=2.0
    )
    assert sol.us.dtype == torch.float64
    golden = np.load(GOLDEN)
    np.testing.assert_allclose(sol.us.numpy(), golden["us"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(sol.objs.numpy(), golden["objs"], atol=1e-5, rtol=0)
    printed = capsys.readouterr().out.splitlines()
    assert (len(printed) == 15) == ("verbose" in VARIANTS[variant])  # the non-fused loop ran


@pytest.mark.parametrize("variant", ["fused", "non_fused"])
@pytest.mark.parametrize("name", ZOO)
def test_zoo_float64_solve_holds_the_golden(name, variant, capsys):
    x, n, m, T, (lo, hi) = golden_case(name)
    dx = port_model(name, torch.float64)
    q, p = dx.get_true_obj()
    config = tdm.MPCConfig(
        n_state=n, n_ctrl=m, T=T, lqr_iter=15, eps=0.0, not_improved_lim=10**6,
        exit_unconverged=False, detach_unconverged=False, verbose=int(variant == "non_fused"),
    )
    sol = tdm.mpc_solve(config, torch.tensor(x), tdm.QuadCost(torch.diag(q), p), dx, u_lower=lo, u_upper=hi)
    assert sol.us.dtype == torch.float64
    golden = np.load(os.path.join(os.path.dirname(__file__), "golden", f"{GOLDENS[name]}.npz"))
    np.testing.assert_allclose(sol.us.numpy(), golden["us"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(sol.objs.numpy(), golden["objs"], atol=1e-5, rtol=0)
    printed = capsys.readouterr().out.splitlines()
    assert (len(printed) == 15) == (variant == "non_fused")  # the non-fused loop ran
