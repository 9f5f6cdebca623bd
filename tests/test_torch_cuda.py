"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: these skip without a CUDA device. On a machine with one,
where JAX need not be installed, run them without the JAX test config:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the iLQR kernel at ``lqr_iter=1, eps=0`` within 1e-4 with
``n_iters`` equal, four iterations by the chaos rule of
tests/torch_parity.py; the KKT kernel (one linear pass) within
``1e-4 * max(1, max|plain|)``; gradients through ``mpc_solve`` on the card
against the CPU within 1e-3 of each gradient's max-abs after one iteration.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import diffmpc_tpu_torch as tdm  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.ilqr import ilqr_solve_fused, ilqr_solve_plain  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.kkt import kkt_backward_fused, kkt_backward_plain  # noqa: E402
from torch_parity import (  # noqa: E402
    as_numpy,
    assert_chaos,
    assert_tight,
    kernel_inputs,
    make_problem,
    random_residuals,
    torch_inputs,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _solve_both(device, prob, **knobs):
    t, dx = torch_inputs(prob, device)
    args = (t["x_init"], t["C"], t["c"], dx, t["u_lower"], t["u_upper"])
    before = ilqr_solve_fused.launches
    kernel = ilqr_solve_fused(*args, u_init=t["u_init"], **knobs)
    torch.cuda.synchronize()
    assert ilqr_solve_fused.launches == before + 1
    plain = ilqr_solve_plain(*args, u_init=t["u_init"], **knobs)
    return as_numpy(kernel), as_numpy(plain)


@pytest.mark.parametrize("B", [48, 130])
@pytest.mark.parametrize("knobs_id", ["cold", "all_knobs"])
def test_kernel_one_iteration_matches_plain(device, B, knobs_id):
    if knobs_id == "cold":
        prob, knobs = make_problem(B=B), {}
    else:
        prob, knobs = make_problem(B=B, warm=True, batched_params=True), dict(delta_u=0.5)
    assert_tight(*_solve_both(device, prob, lqr_iter=1, eps=0.0, **knobs))


@pytest.mark.parametrize("B", [48, 130])
def test_kernel_four_iterations_match_plain(device, B):
    prob = make_problem(seed=704, B=B, warm=True, batched_params=True)
    assert_chaos(*_solve_both(device, prob, lqr_iter=4, eps=1e-5, delta_u=0.5))


def test_wrapper_raises_on_what_the_kernel_does_not_take(device):
    t, dx = torch_inputs(make_problem(), device)
    args = (t["x_init"], t["C"], t["c"], dx, t["u_lower"], t["u_upper"])
    with pytest.raises(ValueError, match="use_cuda=False"):
        ilqr_solve_fused(*args, use_cuda=False)
    # float64 in, float64 out, within 1e-6 of the float32 kernel
    f32 = ilqr_solve_fused(*args, lqr_iter=2)
    f64 = ilqr_solve_fused(*[a.double() if torch.is_tensor(a) else a for a in args], lqr_iter=2)
    assert f64.us.dtype == torch.float64 and f64.n_iters.dtype == torch.int32
    for f in ("xs", "us", "objs", "alpha"):
        torch.testing.assert_close(getattr(f64, f), getattr(f32, f).double(), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="tensors on"):
        ilqr_solve_fused(t["x_init"], t["C"].cpu(), *args[2:])


def test_mpc_solve_on_cuda_goes_through_the_kernel(device):
    t, dx = torch_inputs(make_problem(B=256, T=20), device)
    q, p = dx.get_true_obj()
    config = tdm.MPCConfig(
        n_state=3, n_ctrl=1, T=20, lqr_iter=10, eps=1e-5,
        exit_unconverged=False, detach_unconverged=False,
    )
    before = ilqr_solve_fused.launches
    sol = tdm.mpc_solve(config, t["x_init"], tdm.QuadCost(torch.diag(q), p), dx, u_lower=-2.0, u_upper=2.0)
    torch.cuda.synchronize()
    assert ilqr_solve_fused.launches == before + 1
    assert sol.us.device.type == "cuda" and bool(torch.isfinite(sol.objs).all())
    cpu = tdm.mpc_solve(
        dataclasses.replace(config, use_cuda=False), t["x_init"].cpu(),
        tdm.QuadCost(torch.diag(q).cpu(), p.cpu()), dx.replace(params=dx.params.cpu()),
        u_lower=-2.0, u_upper=2.0,
    )
    # chaos allows single scenarios to settle elsewhere; the batch agrees
    np.testing.assert_allclose(float(sol.objs.mean()), float(cpu.objs.mean()), rtol=1e-2)
    conv_gpu = float(sol.info.converged.float().mean())
    assert abs(conv_gpu - float(cpu.info.converged.float().mean())) <= 0.05


@pytest.mark.parametrize("B", [48, 130])
def test_kkt_kernel_matches_plain(device, B):
    res = random_residuals(np.random.default_rng(830 + B), 20, B, 3, 1, B * 4)
    ins = [torch.tensor(a, device=device) for a in kernel_inputs(res)]
    before = kkt_backward_fused.launches
    got = kkt_backward_fused(*ins)
    torch.cuda.synchronize()
    assert kkt_backward_fused.launches == before + 1
    want = kkt_backward_plain(*ins)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.device == w.device
        bound = 1e-4 * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g, w, atol=bound, rtol=0)


def test_kkt_wrapper_raises_on_what_the_kernel_does_not_take(device):
    res = random_residuals(np.random.default_rng(840), 4, 8, 3, 2)
    ins = [torch.tensor(a, device=device) for a in kernel_inputs(res)]
    before = kkt_backward_fused.launches
    with pytest.raises(NotImplementedError, match="n = 3, m = 1"):
        kkt_backward_fused(*ins)
    res = random_residuals(np.random.default_rng(841), 4, 8, 3, 1)
    ins = [torch.tensor(a, device=device) for a in kernel_inputs(res)]
    with pytest.raises(ValueError, match="tensors on"):
        kkt_backward_fused(ins[0], ins[1].cpu(), *ins[2:])
    with pytest.raises(ValueError, match="use_cuda=False"):
        kkt_backward_fused(*ins, use_cuda=False)
    assert kkt_backward_fused.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gradients_on_the_card_match_the_cpu(device, dtype):
    t, dx = torch_inputs(make_problem(B=256, T=20, batched_params=True))
    q, p = dx.get_true_obj()
    config = tdm.MPCConfig(
        n_state=3, n_ctrl=1, T=20, lqr_iter=1, eps=0.0,
        exit_unconverged=False, detach_unconverged=False,
    )

    def grads(dev):
        leaves = [a.to(dev, dtype).requires_grad_(True) for a in (dx.params, t["x_init"], torch.diag(q), p)]
        sol = tdm.mpc_solve(
            config, leaves[1], tdm.QuadCost(leaves[2], leaves[3]), dx.replace(params=leaves[0]),
            u_lower=-2.0, u_upper=2.0,
        )
        return torch.autograd.grad((sol.us**2).mean(), leaves)

    k_before, i_before = kkt_backward_fused.launches, ilqr_solve_fused.launches
    card = grads(device)
    torch.cuda.synchronize()
    assert kkt_backward_fused.launches == k_before + 1
    assert ilqr_solve_fused.launches == i_before + 1
    for g, w in zip(card, grads("cpu")):
        assert g.dtype == dtype and g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), w, atol=1e-3 * float(w.abs().max()), rtol=0)
