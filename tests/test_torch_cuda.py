"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: these skip without a CUDA device. On a machine with one,
where JAX need not be installed, run them without the JAX test config:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

from the repository root: three tests take their checks from chip_smoke.py.

Tolerances: the iLQR kernel at ``lqr_iter=1, eps=0`` within 1e-4 with
``n_iters`` equal, four iterations by the chaos rule of
tests/torch_parity.py; the KKT and Riccati kernels (one linear pass) within
``1e-4 * max(1, max|plain|)``, the Riccati kernel off its box-QP ties, each
tie checked as one; the rollout kernel's ``objs`` within 1e-5 of the batch's largest
``|objs|`` and ``alpha`` equal; gradients through ``mpc_solve`` on the card against the CPU within
1e-3 of each gradient's max-abs after one iteration. Each streaming twin
against its plain version under the same rules, and against its resident
sibling: the same rules again (the two run the same per-step functions).
The Riccati kernel and its twin at every lane count equal one lane bit for
bit, with and without the simplified value update; so do the KKT kernel and
its twin, on staged inputs and on a C and F read in place (which equal their
staged copies bit for bit).
The pendulum's closed loop over the twins' 96 steps is chaotic enough that
the card's controls and the plain version's part by up to ~6e-4 where the
step agrees: there they are held to 2e-3 (to 1e-4 against the resident
kernel, the same device arithmetic). The depth-blocked sweep within
``1e-4 * max(1, max|plain|)`` of its plain version and ``5e-4`` of the
serial kernel; the piece kernels' ``K, k`` within ``1e-4 * max(1, max|plain|)``
and the rollout's objective within 1e-5 of the batch's largest, at reps 1
and 9, every lane count and read mode of both bit-equal to one lane. The MLP step (learned dynamics): the fused kernel with and without
the pre-pass under the iLQR rules above, the line search and its twin
within 1e-5 of the batch's largest objective with ``alpha`` equal, the
weight gradients within 1e-3 of their max-abs of the CPU's. The
kernel-under-the-mesh probe equals its plain version bit for bit; the dry
run of ``parallel/dryrun.py`` on a one-rank NCCL mesh equals the same steps
without a mesh exactly (one rank's ``all_reduce`` is the identity). No
library the port builds, nor a second build of the Riccati and KKT sources,
exports a GNU unique symbol. The render example's one-robot solve (B=1) of
each env launches once at the wrapper's 16 lanes, in one block, and every
built lane count equals one lane bit for bit. The fused kernel's variants
(their lane groups share the sweep and the linearization out): each env's,
the passthrough wraps' and the (6, 3) MLP's at every lane count, with and
without ``hoist_lin``, cold and warm-started, bit-equal to one lane, one
iteration under the iLQR rule above; every variant key the paths build
within the card's opt-in shared memory a block, at least one block an SM.
A line search on which no candidate improves (the rolled ladder off and on
alpha_floor's bits, the unrolled one), prebuilt and variant, at every lane
count bit-equal to one lane and held to the plain version; the box QP's
projected-Newton loop in the Riccati variants at (6, 3) and (4, 2) under
"0", every lane count bit-equal to one lane, a NaN scenario included.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import diffmpc_tpu_torch as tdm  # noqa: E402
from diffmpc_tpu_torch.models import NNDynamics  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.ilqr import ilqr_solve_fused, ilqr_solve_plain  # noqa: E402
from diffmpc_tpu_torch.ops.cuda import kkt as kkt_mod  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.kkt import kkt_backward_fused, kkt_backward_plain  # noqa: E402
from diffmpc_tpu_torch.ops.cuda import kkt_stream as kkt_stream_mod  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.kkt_stream import kkt_backward_stream_cuda  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.riccati import riccati_backward_cuda, riccati_backward_plain  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.riccati_stream import riccati_backward_stream_cuda  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.rollout import linesearch_rollout_cuda, linesearch_rollout_plain  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.rollout_stream import linesearch_rollout_stream_cuda  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.shard_probe import shard_probe_cuda, shard_probe_plain  # noqa: E402
from diffmpc_tpu_torch.ops.lqr import lqr_rollout  # noqa: E402
from diffmpc_tpu_torch.parallel import dryrun  # noqa: E402
from torch_dist_cases import world_one_mesh  # noqa: E402
from torch_zoo_cases import one_robot_problem  # noqa: E402
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


def _shared_cost(ins):
    """``ins`` with one C for every step and scenario and one F for every
    scenario, expanded (batch stride 0): the kernels read them in place."""
    C, c, F, r, tau, tight = ins
    T, B = C.shape[:2]
    C1 = C[0, 0] @ C[0, 0].T / C.shape[-1] + torch.eye(C.shape[-1], device=C.device)
    out = [C1.expand_as(C), c, F[:, :1].expand_as(F), r, tau, tight]
    assert kkt_mod.reads_in_place(out[0]) and kkt_mod.reads_in_place(out[2])
    return out


def _kkt_same_bits(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shared", [False, True], ids=["staged", "in_place"])
@pytest.mark.parametrize("lanes", kkt_mod.KKT_LANES)
@pytest.mark.parametrize("B", [48, 130])
def test_kkt_kernel_matches_plain(device, B, lanes, shared):
    """The resident kernel at each built lane count, on staged inputs and on
    a C and F read in place: within ``1e-4 * max(1, max|plain|)`` of the
    plain version, and bit for bit the kernel at one lane (and, in place,
    the kernel on the staged copies)."""
    res = random_residuals(np.random.default_rng(830 + B), 20, B, 3, 1, B * 4)
    ins = [torch.tensor(a, device=device) for a in kernel_inputs(res)]
    if shared:
        ins = _shared_cost(ins)
    before = kkt_backward_fused.launches
    got = kkt_mod.run_on_card(kkt_mod._cuda_launcher, *ins, lanes=lanes)
    torch.cuda.synchronize()
    assert kkt_backward_fused.launches == before + 1 and kkt_backward_fused.last_lanes == lanes
    want = kkt_backward_plain(*ins)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.device == w.device
        bound = 1e-4 * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g, w, atol=bound, rtol=0)
    _kkt_same_bits(got, kkt_mod.run_on_card(kkt_mod._cuda_launcher, *ins, lanes=1))
    if shared:
        copies = [a.contiguous() for a in ins]
        _kkt_same_bits(got, kkt_mod.run_on_card(kkt_mod._cuda_launcher, *copies, lanes=lanes))


def test_kkt_wrapper_builds_a_shape_outside_the_table_at_first_use(device):
    """A shape outside the prebuilt table, n = 2, m = 1, launches its variant,
    built at first use, within the bound of test_kkt_kernel_matches_plain.
    Tensors on two devices and a demand for the plain version raise, and
    launch nothing."""
    res = random_residuals(np.random.default_rng(840), 4, 8, 2, 1)
    ins = [torch.tensor(a, device=device) for a in kernel_inputs(res)]
    before = kkt_backward_fused.launches
    got = kkt_backward_fused(*ins)
    torch.cuda.synchronize()
    assert kkt_backward_fused.launches == before + 1
    for g, w in zip(got, kkt_backward_plain(*ins)):
        torch.testing.assert_close(g, w, atol=1e-4 * max(1.0, float(w.abs().max())), rtol=0)
    res = random_residuals(np.random.default_rng(841), 4, 8, 3, 1)
    ins = [torch.tensor(a, device=device) for a in kernel_inputs(res)]
    before = kkt_backward_fused.launches
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


def _random_lqr(rng, T, B, n, m):
    """tests/oracles.py::random_lqr_problem, as float32 numpy (that module
    imports numpy only)."""
    from oracles import random_lqr_problem

    return [a.astype(np.float32) for a in random_lqr_problem(rng, T, B, n, m)]


@pytest.mark.parametrize("mode", ["free", "box", "mask"])
@pytest.mark.parametrize("n,m", [(3, 1), (3, 2), (4, 1), (4, 2)])
def test_riccati_kernel_matches_plain(device, n, m, mode):
    T, B = 20, 130
    rng = np.random.default_rng(880 + 10 * n + m)
    C, c, F, f = (torch.tensor(a, device=device) for a in _random_lqr(rng, T, B, n, m)[:4])
    kw = {}
    if mode == "box":
        u_hat = torch.tensor(rng.uniform(-0.3, 0.3, (T, B, m)), dtype=torch.float32, device=device)
        kw = dict(u_lower=torch.tensor(-0.5, device=device), u_upper=torch.tensor(0.5, device=device), u_hat=u_hat)
    elif mode == "mask":
        kw = dict(ctrl_mask=torch.tensor(rng.random((T, B, m)) < 0.3, device=device))
    before = riccati_backward_cuda.launches
    got = riccati_backward_cuda(C, c, F, f, n, **kw)
    torch.cuda.synchronize()
    assert riccati_backward_cuda.launches == before + 1
    want, Quu, qu = riccati_backward_plain(C, c, F, f, n, return_qp=True, **kw)
    assert got.K.device.type == "cuda" and got.k.device.type == "cuda"
    # K, k within 1e-4 * max(1, max|plain|) off the box-QP ties; each tie a
    # real one (both answers score alike on the plain version's QP), on at
    # most 0.1% of the entries (chip_smoke.py, phase 9)
    from chip_smoke import riccati_agreement

    riccati_agreement(f"{mode} n={n} m={m}", got, want, Quu, qu)


@pytest.mark.parametrize("case", ["free", "box", "pendulum"])
def test_rollout_kernel_matches_plain(device, case):
    T, B = 20, 130
    rng = np.random.default_rng(890)
    if case == "pendulum":
        t, dx = torch_inputs(make_problem(B=B, T=T, batched_params=True, warm=True), device)
        n, m = 3, 1
        x0, C, c, F, f = t["x_init"], t["C"], t["c"], None, None
        kw = dict(u_lower=t["u_lower"], u_upper=t["u_upper"], dyn=dx)
    else:
        n, m = 4, 2
        C, c, F, f, x0 = (torch.tensor(a, device=device) for a in _random_lqr(rng, T, B, n, m))
        kw = {} if case == "free" else dict(u_lower=torch.tensor(-0.7, device=device), u_upper=torch.full((T, B, m), 0.7, device=device))
    x_hat = torch.tensor(rng.normal(size=(T, B, n)), dtype=torch.float32, device=device)
    u_hat = torch.tensor(rng.uniform(-0.3, 0.3, (T, B, m)), dtype=torch.float32, device=device)
    K = torch.tensor(rng.normal(size=(T, B, m, n)) * 0.3, dtype=torch.float32, device=device)
    k = torch.tensor(rng.normal(size=(T, B, m)), dtype=torch.float32, device=device)
    args = (x0, C, c, F, f, K, k, x_hat, u_hat)
    before = linesearch_rollout_cuda.launches
    got = linesearch_rollout_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert linesearch_rollout_cuda.launches == before + 1
    want = linesearch_rollout_plain(*args, **kw)
    torch.testing.assert_close(got.objs, want.objs, rtol=0, atol=1e-5 * float(want.objs.abs().max()))
    assert float((got.alpha == want.alpha).float().mean()) >= 0.99
    same = got.alpha == want.alpha
    torch.testing.assert_close(got.us[:, same], want.us[:, same], atol=1e-4, rtol=0)


def test_mpc_solve_on_lin_dx_goes_through_the_riccati_and_rollout_kernels(device):
    T, B, n, m = 20, 128, 4, 2
    C, c, F, f, x0 = _random_lqr(np.random.default_rng(900), T, B, n, m)
    config = tdm.MPCConfig(n_state=n, n_ctrl=m, T=T, lqr_iter=10, exit_unconverged=False)

    def solve(dev, grad=False):
        leaves = [torch.tensor(a, device=dev, requires_grad=grad) for a in (x0, C, c, F, f)]
        sol = tdm.mpc_solve(config, leaves[0], tdm.QuadCost(leaves[1], leaves[2]), tdm.LinDx(leaves[3], leaves[4]),
                            u_lower=-0.6, u_upper=0.6)
        if not grad:
            return sol, None
        return sol, torch.autograd.grad((sol.us**2).mean() + sol.xs.mean(), leaves)

    counts = lambda: (riccati_backward_cuda.launches, linesearch_rollout_cuda.launches,  # noqa: E731
                      ilqr_solve_fused.launches, kkt_backward_fused.launches)
    before = counts()
    card, _ = solve(device)
    torch.cuda.synchronize()
    it = int(card.info.n_iters)
    assert tuple(a - b for a, b in zip(counts(), before)) == (it, it, 0, 0)
    cpu, _ = solve("cpu")
    # the same objectives; controls within 1e-4 on >= 95% of the scenarios:
    # a box-QP tie (chip_smoke.py, phase 11) may leave one elsewhere on the
    # same float32 objective, within 5e-3
    torch.testing.assert_close(card.objs.cpu(), cpu.objs, rtol=1e-5, atol=1e-5)
    us_diff = (card.us.cpu() - cpu.us).abs().amax(dim=(0, 2))
    agree = us_diff <= 1e-4
    assert float(agree.float().mean()) >= 0.95 and float(us_diff.max()) <= 5e-3
    # the second witness: the problem's optimum in float64; the card's
    # controls score within 1e-5 of it on every scenario
    from chip_smoke import box_lqr_optimum

    box32 = float(np.float32(0.6))
    objective, u_opt, opt_pg = box_lqr_optimum(*(torch.tensor(a) for a in (C, c, F, f, x0)), -box32, box32)
    j_opt = objective(u_opt)
    assert opt_pg <= 1e-8
    assert float(((objective(card.us) - j_opt) / j_opt.abs().clamp_min(1.0)).max()) <= 1e-5
    before = counts()
    card, g_card = solve(device, grad=True)
    torch.cuda.synchronize()
    assert counts()[3] - before[3] == 1
    _, g_cpu = solve("cpu", grad=True)
    for i, (g, w) in enumerate(zip(g_card, g_cpu)):
        g, w = (g.cpu()[agree], w[agree]) if i == 0 else (g.cpu()[:, agree], w[:, agree])
        torch.testing.assert_close(g, w, atol=1e-3 * float(w.abs().max()), rtol=0)


# ---------------------------------------------------------------------------
# The streaming twins and the long-horizon path.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["free", "box", "mask"])
@pytest.mark.parametrize("n,m", [(3, 1), (4, 2)])
def test_riccati_twin_matches_plain_and_resident(device, n, m, mode):
    T, B = 96, 130
    rng = np.random.default_rng(1880 + 10 * n + m)
    C, c, F, f = (torch.tensor(a, device=device) for a in _random_lqr(rng, T, B, n, m)[:4])
    kw = {}
    if mode == "box":
        u_hat = torch.tensor(rng.uniform(-0.3, 0.3, (T, B, m)), dtype=torch.float32, device=device)
        kw = dict(u_lower=torch.tensor(-0.5, device=device), u_upper=torch.tensor(0.5, device=device), u_hat=u_hat)
    elif mode == "mask":
        kw = dict(ctrl_mask=torch.tensor(rng.random((T, B, m)) < 0.3, device=device))
    before = riccati_backward_stream_cuda.launches
    got = riccati_backward_stream_cuda(C, c, F, f, n, **kw)
    torch.cuda.synchronize()
    assert riccati_backward_stream_cuda.launches == before + 1
    want, Quu, qu = riccati_backward_plain(C, c, F, f, n, return_qp=True, **kw)
    from chip_smoke import riccati_agreement

    riccati_agreement(f"twin {mode} n={n} m={m}", got, want, Quu, qu)
    riccati_agreement(f"twin vs resident {mode} n={n} m={m}", got, riccati_backward_cuda(C, c, F, f, n, **kw), Quu, qu)


def _assert_line_searches_agree(got, want, us_tol=1e-4):
    torch.testing.assert_close(got.objs, want.objs, rtol=0, atol=1e-5 * float(want.objs.abs().max()))
    same = got.alpha == want.alpha
    assert float(same.float().mean()) >= 0.99
    torch.testing.assert_close(got.us[:, same], want.us[:, same], atol=us_tol, rtol=0)


@pytest.mark.parametrize("B", [128, 1000])
@pytest.mark.parametrize("n,m,mode", [(4, 2, "box"), (3, 1, "box"), (3, 2, "free"), (4, 1, "mask")])
def test_riccati_lane_kernels_match_plain(device, n, m, mode, B):
    """The Riccati kernel and its twin at every built lane count (one lane
    staged and reading device memory), on the same staged inputs: each bit
    for bit the resident kernel at one lane reading device memory, which
    holds the plain version by phase 9's rule; with the simplified value
    update the same."""
    from chip_smoke import riccati_agreement
    from diffmpc_tpu_torch.ops.cuda import riccati as ric
    from diffmpc_tpu_torch.ops.cuda import riccati_stream as rs

    T = 20
    rng = np.random.default_rng(2870 + B + 10 * n + m)
    C, c, F, f = (torch.tensor(a, device=device) for a in _random_lqr(rng, T, B, n, m)[:4])
    kw = {}
    if mode == "box":
        u_hat = torch.tensor(rng.uniform(-0.3, 0.3, (T, B, m)), dtype=torch.float32, device=device)
        kw = dict(u_lower=torch.tensor(-0.5, device=device), u_upper=torch.tensor(0.5, device=device), u_hat=u_hat)
    elif mode == "mask":
        kw = dict(ctrl_mask=torch.tensor(rng.random((T, B, m)) < 0.3, device=device))
    launchers = {"riccati": ric._cuda_launcher, "riccati_stream": rs._stream_launcher}
    for exact_reg in (-1.0, 1e-6):
        knobs = dict(kw, value_update_exact_reg=exact_reg)
        one = ric.run_staged_riccati(launchers["riccati"](device, n, m), C, c, F, f, n, staged=False, **knobs)
        want, Quu, qu = ric.riccati_backward_plain(C, c, F, f, n, return_qp=True, **knobs)
        torch.cuda.synchronize()
        riccati_agreement(f"{mode} n={n} m={m} B={B}", one, want, Quu, qu)
        for kind, launcher in launchers.items():
            for lanes in ric.RICCATI_LANES:
                for staged in (True, False) if lanes == 1 else (True,):
                    got = ric.run_staged_riccati(launcher(device, n, m), C, c, F, f, n, lanes=lanes, staged=staged,
                                                 **knobs)
                    torch.cuda.synchronize()
                    for name, g, w in zip(got._fields, got, one):
                        assert torch.equal(g, w), (kind, lanes, staged, exact_reg, name)


@pytest.mark.parametrize("n,m,B,want", [(4, 2, 16384, True), (4, 2, 65536, False), (3, 1, 1024, True)])
def test_riccati_launcher_stages_while_a_wave_holds_the_batch(device, n, m, B, want):
    """At one lane the launcher stages each step's slice while the batch fits
    the card in one wave of staged blocks (on an H100's 132 SMs: config 2's
    box step at 16,384 stages, at 65,536 reads device memory; the
    pendulum's at 1024 stages), writes its choice back into the args, and
    stages or not as asked where the args say."""
    from diffmpc_tpu_torch.ops.cuda import riccati as ric

    if torch.cuda.get_device_properties(device).multi_processor_count != 132:
        pytest.skip("the batches are an H100's")
    T = 2
    rng = np.random.default_rng(2880 + n + m)
    C, c, F, f = (torch.tensor(a, device=device) for a in _random_lqr(rng, T, B, n, m)[:4])
    box = dict(u_lower=torch.tensor(-0.5, device=device), u_upper=torch.tensor(0.5, device=device),
               u_hat=torch.zeros((T, B, m), device=device))
    ric.riccati_backward_cuda(C, c, F, f, n, **box)
    assert (ric.riccati_backward_cuda.last_lanes, ric.riccati_backward_cuda.last_staged) == (1, want)
    for asked in (True, False):
        ric.run_staged_riccati(ric._cuda_launcher(device, n, m), C, c, F, f, n, staged=asked, **box)
        assert ric.riccati_backward_cuda.last_staged == asked


@pytest.mark.parametrize("B", [128, 1000])
@pytest.mark.parametrize("case", ["box", "pendulum"])
def test_rollout_lane_kernels_match_plain(device, case, B):
    """The resident line search and its twin at every built lane count, on
    the same staged inputs: each bit for bit the resident kernel at one
    lane, which holds the plain version (objs within 1e-5 of the largest,
    alpha equal on >= 99%, us within 1e-4 where it agrees)."""
    from diffmpc_tpu_torch.ops.cuda import rollout as rol
    from diffmpc_tpu_torch.ops.cuda import rollout_stream as ros

    T = 20
    rng = np.random.default_rng(2890 + B)
    if case == "pendulum":
        t, dx = torch_inputs(make_problem(B=B, T=T, batched_params=True, warm=True), device)
        n, m = 3, 1
        x0, C, c, F, f = t["x_init"], t["C"], t["c"], None, None
        kw = dict(u_lower=t["u_lower"], u_upper=t["u_upper"], dyn=dx, delta_u=1.0)
    else:
        n, m = 4, 2
        C, c, F, f, x0 = (torch.tensor(a, device=device) for a in _random_lqr(rng, T, B, n, m))
        kw = dict(u_lower=torch.tensor(-0.7, device=device), u_upper=torch.full((T, B, m), 0.7, device=device))
    x_hat = torch.tensor(rng.normal(size=(T, B, n)), dtype=torch.float32, device=device)
    u_hat = torch.tensor(rng.uniform(-0.3, 0.3, (T, B, m)), dtype=torch.float32, device=device)
    K = torch.tensor(rng.normal(size=(T, B, m, n)) * 0.3, dtype=torch.float32, device=device)
    k = torch.tensor(rng.normal(size=(T, B, m)) * rng.uniform(0.5, 8.0, (1, B, 1)), dtype=torch.float32, device=device)
    args = (x0, C, c, F, f, K, k, x_hat, u_hat)
    launchers = {"rollout": rol._cuda_launcher, "rollout_stream": ros._stream_launcher}
    one = rol.run_staged_rollout(launchers["rollout"](device, n, m, kw.get("dyn")), *args, **kw)
    torch.cuda.synchronize()
    _assert_line_searches_agree(one, linesearch_rollout_plain(*args, **kw))
    assert len(torch.unique(one.alpha)) > 1
    for kind, launcher in launchers.items():
        for lanes in rol.ROLLOUT_LANES:
            got = rol.run_staged_rollout(launcher(device, n, m, kw.get("dyn")), *args, lanes=lanes, **kw)
            torch.cuda.synchronize()
            for name, g, w in zip(got._fields, got, one):
                assert torch.equal(g, w), (kind, lanes, name)


# ladders of the line search with nothing improving: (decay, n_alpha,
# unroll): the rolled ladder off alpha_floor's bits (0.2 * 0.2 is not
# float32(0.04)) and on them (halving), and the unrolled one
NO_IMPROVEMENT_LADDERS = {"rolled_off_floor": (0.2, 3, False), "rolled_on_floor": (0.5, 10, False),
                          "unrolled": (0.2, 4, True)}


def _no_improvement_inputs(case: str, ladder: str, device, B: int = 1000, T: int = 20):
    """A line search on which no candidate improves: linear (4, 2) dynamics
    about the problem's optimum (the plain free sweep's policy) with a
    random feedforward, every step up the quadratic; the pendulum, the
    acrobot (n + m = 7) and the vehicle's slew wrap (n + m = 8) with a zero
    cost, every candidate tying the baseline."""
    from torch_zoo_cases import kernel_problem

    decay, n_alpha, unroll = NO_IMPROVEMENT_LADDERS[ladder]
    rng = np.random.default_rng(2900 + B)
    kw = dict(decay=decay, max_iter=n_alpha, unroll=unroll)
    if case == "linear":
        n, m = 4, 2
        C, c, F, f, x0 = (torch.tensor(a, device=device) for a in _random_lqr(rng, T, B, n, m))
        gains = riccati_backward_plain(C, c, F, f, n)
        x_hat, u_hat = lqr_rollout(x0, F, f, gains.K, gains.k)
        k = torch.tensor(rng.normal(size=(T, B, m)) * 20.0, dtype=torch.float32, device=device)
        return (x0, C, c, F, f, gains.K, k, x_hat, u_hat), kw
    if case == "pendulum":
        t, dyn = torch_inputs(make_problem(B=B, T=T, batched_params=True, warm=True), device)
        x0, lo, hi = t["x_init"], t["u_lower"], t["u_upper"]
    else:
        x0, _, _, dyn, lo, hi = (a.to(device=device) for a in kernel_problem(
            "acrobot" if case == "acrobot" else "vehicle", B, T, torch.float32, seed=2901))
        if case == "pt_vehicle":
            from diffmpc_tpu_torch.models import CtrlPassthroughDynamics

            x0 = torch.cat([torch.zeros((B, 2), device=device), x0], -1)
            dyn = CtrlPassthroughDynamics(inner=dyn, n_ctrl=2)
    n, m = x0.shape[-1], lo.shape[-1]
    u_hat = lo + (hi - lo) * torch.tensor(rng.uniform(0.2, 0.8, (T, B, m)), dtype=torch.float32, device=device)
    xs = [x0]
    for t_ in range(T - 1):
        xs.append(dyn.forward(xs[-1], u_hat[t_]))
    K = torch.tensor(rng.normal(size=(T, B, m, n)) * 0.1, dtype=torch.float32, device=device)
    k = torch.tensor(rng.normal(size=(T, B, m)), dtype=torch.float32, device=device)
    zeros = torch.zeros((T, B, n + m, n + m), device=device), torch.zeros((T, B, n + m), device=device)
    return (x0, *zeros, None, None, K, k, torch.stack(xs), u_hat), dict(kw, u_lower=lo, u_upper=hi, dyn=dyn)


@pytest.mark.parametrize("ladder", list(NO_IMPROVEMENT_LADDERS))
@pytest.mark.parametrize("case", ["linear", "pendulum", "acrobot", "pt_vehicle"])
def test_rollout_with_nothing_improving_lanes_bit_equal_and_match_plain(device, case, ladder):
    """A line search on which no candidate improves (a converged solve's
    last call): the resident kernel and its twin at every built lane count
    bit for bit the resident kernel at one lane, which holds the plain
    version (alpha_floor everywhere, objs within 1e-5 of the largest, us
    within 1e-4); the prebuilt kernels (linear (4, 2), the pendulum) and
    the variants of n + m = 7 and 8 (the acrobot, the vehicle's wrap)."""
    from diffmpc_tpu_torch.ops.cuda import rollout as rol
    from diffmpc_tpu_torch.ops.cuda import rollout_stream as ros

    args, kw = _no_improvement_inputs(case, ladder, device)
    n, m = args[0].shape[-1], args[6].shape[-1]
    want = linesearch_rollout_plain(*args, **kw)
    assert not bool(want.improved.any())
    launchers = {"rollout": rol._cuda_launcher, "rollout_stream": ros._stream_launcher}
    one = rol.run_staged_rollout(launchers["rollout"](device, n, m, kw.get("dyn")), *args, **kw)
    torch.cuda.synchronize()
    _assert_line_searches_agree(one, want)
    assert bool((one.alpha == want.alpha).all())
    for kind, launcher in launchers.items():
        for lanes in rol.ROLLOUT_LANES:
            got = rol.run_staged_rollout(launcher(device, n, m, kw.get("dyn")), *args, lanes=lanes, **kw)
            torch.cuda.synchronize()
            for name, g, w in zip(got._fields, got, one):
                assert torch.equal(g, w), (kind, lanes, name)


@pytest.mark.parametrize("n,m,enum", [(6, 3, ""), (4, 2, "0")])
def test_riccati_projected_newton_variants_lanes_bit_equal(device, n, m, enum):
    """The box QP's projected-Newton loop (left once done; at 16 lanes its
    Armijo candidates shared out and picked by a ballot) in the Riccati
    variants at (6, 3) and, under "0", (4, 2): the kernel and its twin at
    every built lane count (one lane staged and not) bit for bit the
    resident kernel at one lane, NaN positions included (a NaN in one
    scenario's C), which holds the plain version by phase 9's rule off that
    scenario."""
    from chip_smoke import riccati_agreement, same_bits
    from diffmpc_tpu_torch.ops.cuda import riccati as ric
    from diffmpc_tpu_torch.ops.cuda import riccati_stream as rs

    T, B = 20, 1000
    rng = np.random.default_rng(2910 + 10 * n + m)
    C, c, F, f = (torch.tensor(a, device=device) for a in _random_lqr(rng, T, B, n, m)[:4])
    u_hat = torch.tensor(rng.uniform(-0.3, 0.3, (T, B, m)), dtype=torch.float32, device=device)
    kw = dict(u_lower=torch.tensor(-0.5, device=device), u_upper=torch.tensor(0.5, device=device), u_hat=u_hat,
              pnqp_enum=enum)
    want, Quu, qu = ric.riccati_backward_plain(C, c, F, f, n, return_qp=True, **kw)
    one = ric.run_staged_riccati(ric._cuda_launcher(device, n, m, pnqp_enum=enum), C, c, F, f, n, staged=False, **kw)
    torch.cuda.synchronize()
    riccati_agreement(f"loop n={n} m={m} {enum!r}", one, want, Quu, qu)
    assert float(one.n_qp_iter.float().max()) > 1.0
    C[T // 2, 7, n, n + 1] = C[T // 2, 7, n + 1, n] = float("nan")
    one = ric.run_staged_riccati(ric._cuda_launcher(device, n, m, pnqp_enum=enum), C, c, F, f, n, staged=False, **kw)
    assert bool(torch.isnan(one.k[:, 7]).any()) and not bool(torch.isnan(one.k[:, 8:]).any())
    for kind, launcher in {"riccati": ric._cuda_launcher, "riccati_stream": rs._stream_launcher}.items():
        for lanes in ric.RICCATI_LANES:
            for staged in (True, False) if lanes == 1 else (True,):
                got = ric.run_staged_riccati(launcher(device, n, m, pnqp_enum=enum), C, c, F, f, n, lanes=lanes,
                                             staged=staged, **kw)
                torch.cuda.synchronize()
                for name, g, w in zip(got._fields, got, one):
                    assert same_bits(g, w), (kind, lanes, staged, name)


@pytest.mark.parametrize("case", ["free", "box", "pendulum"])
def test_rollout_twin_matches_plain_and_resident(device, case):
    T, B = 96, 130
    rng = np.random.default_rng(1890)
    if case == "pendulum":
        t, dx = torch_inputs(make_problem(B=B, T=T, batched_params=True, warm=True), device)
        n, m = 3, 1
        x0, C, c, F, f = t["x_init"], t["C"], t["c"], None, None
        kw = dict(u_lower=t["u_lower"], u_upper=t["u_upper"], dyn=dx, delta_u=1.0)
    else:
        n, m = 4, 2
        C, c, F, f, x0 = (torch.tensor(a, device=device) for a in _random_lqr(rng, T, B, n, m))
        kw = {} if case == "free" else dict(u_lower=torch.tensor(-0.7, device=device), u_upper=torch.full((T, B, m), 0.7, device=device))
    x_hat, _ = lqr_rollout(x0, F, f, torch.zeros((T, B, m, n), device=device), torch.zeros((T, B, m), device=device)) \
        if F is not None else (torch.tensor(rng.normal(size=(T, B, n)), dtype=torch.float32, device=device), None)
    u_hat = torch.tensor(rng.uniform(-0.3, 0.3, (T, B, m)), dtype=torch.float32, device=device)
    K = torch.tensor(rng.normal(size=(T, B, m, n)) * 0.1, dtype=torch.float32, device=device)
    k = torch.tensor(rng.normal(size=(T, B, m)) * 2.0, dtype=torch.float32, device=device)
    args = (x0, C, c, F, f, K, k, x_hat, u_hat)
    before = linesearch_rollout_stream_cuda.launches
    got = linesearch_rollout_stream_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert linesearch_rollout_stream_cuda.launches == before + 1
    # the pendulum's step is chaotic: over 96 steps the card's sinf/cosf and
    # the plain version's part by up to ~6e-4 on a control; against the
    # resident kernel, the same device arithmetic, 1e-4 holds
    _assert_line_searches_agree(got, linesearch_rollout_plain(*args, **kw), us_tol=2e-3 if case == "pendulum" else 1e-4)
    _assert_line_searches_agree(got, linesearch_rollout_cuda(*args, **kw))
    assert len(torch.unique(got.alpha)) > 1


@pytest.mark.parametrize("shared", [False, True], ids=["staged", "in_place"])
@pytest.mark.parametrize("lanes", kkt_mod.KKT_LANES)
@pytest.mark.parametrize("n,m", [(3, 1), (4, 2)])
def test_kkt_twin_matches_plain_and_resident(device, n, m, lanes, shared):
    """The twin at each built lane count, on staged inputs and on a C and F
    read in place: within ``1e-4 * max(1, max|plain|)`` of the plain
    version, and bit for bit the resident kernel at one lane."""
    res = random_residuals(np.random.default_rng(1830 + 10 * n + m), 96, 130, n, m, 130 * 20)
    ins = [torch.tensor(a, device=device) for a in kernel_inputs(res)]
    if shared:
        ins = _shared_cost(ins)
    before = kkt_backward_stream_cuda.launches
    got = kkt_mod.run_on_card(kkt_stream_mod._stream_launcher, *ins, lanes=lanes)
    torch.cuda.synchronize()
    assert kkt_backward_stream_cuda.launches == before + 1 and kkt_backward_stream_cuda.last_lanes == lanes
    assert not kkt_backward_stream_cuda.last_on_chip
    for g, w in zip(got, kkt_backward_plain(*ins)):
        bound = 1e-4 * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g, w, atol=bound, rtol=0)
    _kkt_same_bits(got, kkt_mod.run_on_card(kkt_mod._cuda_launcher, *ins, lanes=1))


def test_long_horizon_mpc_solve_goes_through_the_twins(device):
    """Box-DDP config 2 at T=128: each iteration launches the Riccati and the
    rollout twins, the gradient the KKT twin, and no resident kernel."""
    T, B, n, m = 128, 128, 4, 2
    C, c, F, f, x0 = _random_lqr(np.random.default_rng(1900), T, B, n, m)
    config = tdm.MPCConfig(n_state=n, n_ctrl=m, T=T, lqr_iter=10, exit_unconverged=False)
    kernels = (riccati_backward_stream_cuda, linesearch_rollout_stream_cuda, kkt_backward_stream_cuda,
               riccati_backward_cuda, linesearch_rollout_cuda, kkt_backward_fused, ilqr_solve_fused)
    before = [k.launches for k in kernels]
    leaves = [torch.tensor(a, device=device, requires_grad=True) for a in (x0, C, c, F, f)]
    sol = tdm.mpc_solve(config, leaves[0], tdm.QuadCost(leaves[1], leaves[2]), tdm.LinDx(leaves[3], leaves[4]),
                        u_lower=-0.6, u_upper=0.6)
    grads = torch.autograd.grad((sol.us**2).mean() + sol.xs.mean(), leaves)
    torch.cuda.synchronize()
    it = int(sol.info.n_iters)
    assert [k.launches - b for k, b in zip(kernels, before)] == [it, it, 1, 0, 0, 0, 0]
    assert bool(torch.isfinite(sol.objs).all()) and float(sol.us.abs().max()) <= np.float32(0.6)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("block", [2, 4])
@pytest.mark.parametrize("n,m", [(3, 1), (3, 2), (4, 1), (4, 2)])
def test_blocked_kernel_matches_plain_and_serial(device, n, m, block):
    """The depth-blocked sweep: K, k within 1e-4 * max(1, max|plain|) of its
    plain version, and within 5e-4 of the serial kernel's free mode (the JAX
    package's bound between the two sweeps); the validation raises on the
    card too."""
    from diffmpc_tpu_torch.ops.cuda import riccati_blocked as rb

    T, B = 20, 130
    C, c, F, f = (torch.tensor(a, device=device) for a in _random_lqr(np.random.default_rng(1950 + 10 * n + m), T, B, n, m)[:4])
    before = rb.riccati_backward_blocked_cuda.launches
    got = rb.riccati_backward_blocked(C, c, F, f, n, block=block)
    torch.cuda.synchronize()
    assert rb.riccati_backward_blocked_cuda.launches == before + 1
    assert got.K.device.type == "cuda" and bool(got.free_mask.all())
    want = rb.riccati_backward_blocked_plain(C, c, F, f, n, block=block)
    serial = riccati_backward_cuda(C, c, F, f, n)
    for name in ("K", "k"):
        g, w, s = getattr(got, name), getattr(want, name), getattr(serial, name)
        torch.testing.assert_close(g, w, atol=1e-4 * max(1.0, float(w.abs().max())), rtol=0)
        torch.testing.assert_close(g, s, atol=5e-4 * max(1.0, float(s.abs().max())), rtol=0)
    with pytest.raises(ValueError, match="block must be 2 or 4"):
        rb.riccati_backward_blocked(C, c, F, f, n, block=3)
    with pytest.raises(ValueError, match="must evenly divide"):
        rb.riccati_backward_blocked(C[:18], c[:18], F[:18], f[:18], n, block=4)


@pytest.mark.parametrize("T,block,B", [(128, 2, 40), (20, 4, 1000), (128, 4, 130)])
def test_blocked_kernel_threads_match_plain_and_serial(device, T, block, B):
    """The (block, scenario) threads at (4, 2): T / D = 64 (a scenario over
    two warps, the carry through shared memory), 5 (not a power of two) and
    32, ragged B: K, k within 1e-4 * max(1, max|plain|) of the plain version
    and 5e-4 of the serial kernel."""
    from diffmpc_tpu_torch.ops.cuda import riccati_blocked as rb

    n, m = 4, 2
    C, c, F, f = (torch.tensor(a, device=device) for a in _random_lqr(np.random.default_rng(1960 + T + block), T, B, n, m)[:4])
    got = rb.riccati_backward_blocked_cuda(C, c, F, f, n, block=block)
    torch.cuda.synchronize()
    want = rb.riccati_backward_blocked_plain(C, c, F, f, n, block=block)
    serial = riccati_backward_cuda(C, c, F, f, n)
    for name in ("K", "k"):
        g, w, s = getattr(got, name), getattr(want, name), getattr(serial, name)
        torch.testing.assert_close(g, w, atol=1e-4 * max(1.0, float(w.abs().max())), rtol=0)
        torch.testing.assert_close(g, s, atol=5e-4 * max(1.0, float(s.abs().max())), rtol=0)


def test_blocked_wrapper_builds_a_shape_outside_the_table_at_first_use(device):
    """At n = 2, m = 1, outside the prebuilt table, the blocked kernel and
    its longest-horizon query come from its variant, built at first use: K, k
    within 1e-4 * max(1, max|plain|) of the plain version at D = 2 and 4."""
    from diffmpc_tpu_torch.ops.cuda import riccati_blocked as rb

    n, m = 2, 1
    C, c, F, f = (torch.tensor(a, device=device) for a in _random_lqr(np.random.default_rng(1990), 8, 40, n, m)[:4])
    for block in (2, 4):
        assert rb.max_horizon(device, n, m, block) >= 64 * block
        got = rb.riccati_backward_blocked_cuda(C, c, F, f, n, block=block)
        want = rb.riccati_backward_blocked_plain(C, c, F, f, n, block=block)
        for name in ("K", "k"):
            g, w = getattr(got, name), getattr(want, name)
            torch.testing.assert_close(g, w, atol=1e-4 * max(1.0, float(w.abs().max())), rtol=0)


@pytest.mark.parametrize("block", [2, 4])
def test_blocked_kernel_longest_horizon(device, block):
    """At (4, 2) the kernel runs at its longest horizon (``max_horizon``: one
    CTA holds a scenario's T / D threads) and agrees with the serial kernel
    within 5e-4 of its scale; one block more raises ValueError naming the
    longest, and launches nothing."""
    from diffmpc_tpu_torch.ops.cuda import riccati_blocked as rb

    n, m = 4, 2
    longest = rb.max_horizon(device, n, m, block)
    assert longest % block == 0 and longest >= 64 * block
    C, c, F, f = (torch.tensor(a, device=device) for a in _random_lqr(np.random.default_rng(1980 + block), longest + block,
                                                                       3, n, m)[:4])
    got = rb.riccati_backward_blocked_cuda(C[:longest], c[:longest], F[:longest], f[:longest], n, block=block)
    serial = riccati_backward_cuda(C[:longest], c[:longest], F[:longest], f[:longest], n)
    for name in ("K", "k"):
        g, s = getattr(got, name), getattr(serial, name)
        torch.testing.assert_close(g, s, atol=5e-4 * max(1.0, float(s.abs().max())), rtol=0)
    before = rb.riccati_backward_blocked_cuda.launches
    with pytest.raises(ValueError, match=f"T <= {longest}"):
        rb.riccati_backward_blocked_cuda(C, c, F, f, n, block=block)
    assert rb.riccati_backward_blocked_cuda.launches == before


@pytest.mark.parametrize("kind", ["full", "no_lin", "no_Qform", "no_pnqp", "no_Vup", "rollout"])
def test_piece_sweep_lane_groups_bit_equal(device, kind):
    """The piece sweep and the rollout at every built lane count, staged and
    reading device memory, reps 1 and 9: bit-equal to one lane reading
    device memory."""
    from diffmpc_tpu_torch.diagnostics.profile_riccati_pieces import make_inputs
    from diffmpc_tpu_torch.ops.cuda import riccati_pieces as rp

    ins = make_inputs(130, device, steps=20)
    counted = rp.rollout_piece_cuda if kind == "rollout" else rp.sweep_piece_cuda

    def call(**kw):
        if kind == "rollout":
            return (rp.rollout_piece_cuda(*ins, **kw),)
        return rp.sweep_piece_cuda(kind, *ins, **kw)

    for reps in (1, 9):
        one = call(reps=reps, lanes=1, staged=False)
        for lanes in rp.PIECE_LANES:
            for staged in (False, True):
                got = call(reps=reps, lanes=lanes, staged=staged)
                torch.cuda.synchronize()
                assert counted.last_lanes == lanes
                assert all(torch.equal(g, o) for g, o in zip(got, one)), (lanes, staged, reps)


@pytest.mark.parametrize("kind", ["full", "no_lin", "no_Qform", "no_pnqp", "no_Vup", "rollout"])
def test_piece_kernels_match_plain(device, kind):
    """Each piece kernel at reps 1 and 9 (one binary): the sweep's K, k within
    1e-4 * max(1, max|plain|), each rollout objective within 1e-5 of its sum
    of |stage costs| (a summed cost can cancel to near zero)."""
    from diffmpc_tpu_torch.diagnostics.profile_riccati_pieces import make_inputs
    from diffmpc_tpu_torch.ops.cuda import riccati_pieces as rp

    ins = make_inputs(130, device, steps=20)
    for reps in (1, 9):
        counted = rp.rollout_piece_cuda if kind == "rollout" else rp.sweep_piece_cuda
        before = counted.launches
        if kind == "rollout":
            got, want = rp.rollout_piece_cuda(*ins, reps=reps), rp.rollout_piece_plain(*ins, reps=reps)
            torch.cuda.synchronize()
            assert bool(((got - want.obj).abs() <= 1e-5 * want.abs_cost).all())
        else:
            got, want = rp.sweep_piece_cuda(kind, *ins, reps=reps), rp.sweep_piece_plain(kind, *ins, reps=reps)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, atol=1e-4 * max(1.0, float(w.abs().max())), rtol=0)
        assert counted.launches == before + 1


# ---------------------------------------------------------------------------
# Learned dynamics: the MLP step in the fused solve and the line search.
# ---------------------------------------------------------------------------


def _nn_problem(device, n=3, m=1, hidden=(8,), seed=1200, B=130, T=6):
    """tests/test_torch_kernel_host.py's MLP problem on ``device``: a
    residual MLP with its He-normal weights scaled by 0.3 and perturbed
    biases, the goal cost, box +-2."""
    gen = torch.Generator().manual_seed(seed)
    nn = NNDynamics.init(n, m, hidden=hidden, residual=True, device="cpu", generator=gen)
    nn = nn.replace(weights=tuple(0.3 * w for w in nn.weights),
                    biases=tuple(b + 0.05 * torch.randn(b.shape, generator=gen) for b in nn.biases))
    nm = n + m
    q = torch.tensor([1.0, 1.0, 0.1] + [0.001] * m)
    p = torch.zeros(nm)
    p[0] = -1.0
    box = torch.full((T, B, m), 2.0)
    args = (torch.randn((B, n), generator=gen) * 0.5, torch.diag(q).expand(T, B, nm, nm), p.expand(T, B, nm),
            nn, -box, box)
    return tuple(a.to(device=device) for a in args)


@pytest.mark.parametrize("hoist_lin", [False, True], ids=["in_sweep", "hoist_lin"])
@pytest.mark.parametrize("n,m,hidden", [(3, 1, (8,)), (3, 1, (16, 16)), (3, 2, (8,))])
def test_nn_kernel_matches_plain(device, n, m, hidden, hoist_lin):
    """One iteration within 1e-4 with n_iters equal; four by the chaos rule;
    with and without the pre-pass."""
    args = _nn_problem(device, n, m, hidden)
    for knobs, rule in ((dict(lqr_iter=1, eps=0.0), assert_tight), (dict(lqr_iter=4, eps=1e-5), assert_chaos)):
        before = ilqr_solve_fused.launches
        kernel = ilqr_solve_fused(*args, hoist_lin=hoist_lin, **knobs)
        torch.cuda.synchronize()
        assert ilqr_solve_fused.launches == before + 1
        rule(as_numpy(kernel), as_numpy(ilqr_solve_plain(*args, **knobs)))


def test_nn_architecture_outside_the_table_raises_on_the_card(device):
    """A fusable MLP outside the prebuilt table no longer raises: it launches
    its variant, built at first use, and holds test_nn_kernel_matches_plain's
    rules; nothing falls back to the plain version."""
    args = _nn_problem(device, hidden=(12,))
    assert args[3].kernel_fusable
    for knobs, rule in ((dict(lqr_iter=1, eps=0.0), assert_tight), (dict(lqr_iter=4, eps=1e-5), assert_chaos)):
        before = ilqr_solve_fused.launches
        kernel = ilqr_solve_fused(*args, **knobs)
        torch.cuda.synchronize()
        assert ilqr_solve_fused.launches == before + 1
        rule(as_numpy(kernel), as_numpy(ilqr_solve_plain(*args, **knobs)))


@pytest.mark.parametrize("kernel", ["rollout", "rollout_stream"])
def test_nn_rollout_kernels_match_plain(device, kernel):
    """The line search through the MLP step (the inputs of
    test_torch_kernel_host's): objs within 1e-5 of the batch's largest,
    alpha equal, xs, us within 1e-4."""
    from diffmpc_tpu_torch.ops.linearize import linearize_dynamics
    from diffmpc_tpu_torch.utils.batch import bmv

    x0, C, c, nn, lo, hi = _nn_problem(device, T=20)
    T, B = C.shape[:2]
    gen = torch.Generator(device=device).manual_seed(1210)
    u_hat = torch.rand((T, B, 1), generator=gen, device=device) * 3.0 - 1.5
    xs = [x0]
    for t in range(T - 1):
        xs.append(nn.forward(xs[-1], u_hat[t]))
    x_hat = torch.stack(xs)
    F, _ = linearize_dynamics(nn, x_hat, u_hat)
    gains = riccati_backward_plain(C, c + bmv(C, torch.cat([x_hat, u_hat], -1)), F, None, 3,
                                   u_lower=lo, u_upper=hi, u_hat=u_hat)
    k = gains.k * (0.5 + 7.5 * torch.rand((1, B, 1), generator=gen, device=device))
    args = (x0, C, c, None, None, gains.K, k, x_hat, u_hat)
    kw = dict(u_lower=lo, u_upper=hi, dyn=nn, delta_u=1.0)
    fn = linesearch_rollout_cuda if kernel == "rollout" else linesearch_rollout_stream_cuda
    before = fn.launches
    got = fn(*args, **kw)
    want = linesearch_rollout_plain(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    scale = float(want.objs.abs().max())
    torch.testing.assert_close(got.objs, want.objs, atol=1e-5 * scale, rtol=0)
    assert torch.equal(got.alpha, want.alpha)
    torch.testing.assert_close(got.us, want.us, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.xs, want.xs, atol=1e-4, rtol=0)


def test_nn_mpc_solve_and_weight_gradients_on_the_card(device):
    """mpc_solve with a fusable MLP: one iLQR launch, and with the weights
    requiring grad one KKT launch; the gradients after one iteration within
    1e-3 of their max-abs of the CPU's."""
    config = tdm.MPCConfig(n_state=3, n_ctrl=1, T=6, lqr_iter=1, eps=0.0, exit_unconverged=False,
                           detach_unconverged=False)

    def grads(dev):
        x0, C, c, nn, lo, hi = _nn_problem(dev, B=256)
        leaves = [a.clone().requires_grad_(True) for a in nn.weights + nn.biases]
        model = nn.replace(weights=tuple(leaves[:2]), biases=tuple(leaves[2:]))
        sol = tdm.mpc_solve(config, x0, tdm.QuadCost(C, c), model, u_lower=lo, u_upper=hi)
        return torch.autograd.grad((sol.us**2).mean(), leaves)

    k_before, i_before = kkt_backward_fused.launches, ilqr_solve_fused.launches
    card = grads(device)
    torch.cuda.synchronize()
    assert (kkt_backward_fused.launches, ilqr_solve_fused.launches) == (k_before + 1, i_before + 1)
    for g, w in zip(card, grads("cpu")):
        assert g.device.type == device.type and bool(w.abs().max() > 0)
        torch.testing.assert_close(g.cpu(), w, atol=1e-3 * float(w.abs().max()), rtol=0)


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("L", [1, 2, 3, 8, 1027, 32768, 65536])
def test_probe_kernel_matches_plain(device, L, offset):
    """The probe's grid bit-equal to its plain version, the shard and its
    output ``offset`` floats off a 16-byte boundary (the kernel's scalar head
    and tail around its float4 stores), nothing written outside the shard."""
    x = (torch.arange(L + offset, dtype=torch.float32, device=device) ** 1.5)[offset:]
    before = shard_probe_cuda.launches
    if offset:
        base = torch.full((L + 8,), float("nan"), device=device)
        got = shard_probe_cuda(x, out=base[offset:offset + L])
    else:
        got = shard_probe_cuda(x)
    torch.cuda.synchronize()
    assert shard_probe_cuda.launches == before + 1
    assert torch.equal(got, shard_probe_plain(x))
    if offset:
        assert bool(torch.isnan(base[:offset]).all()) and bool(torch.isnan(base[offset + L:]).all())


def test_no_library_exports_a_gnu_unique_symbol(device, tmp_path):
    """No library the port builds exports a GNU unique symbol (a
    function-local static of an inline function or template, one object
    across every library of the process): the main library, a second build
    of the Riccati and KKT sources beside it (as the A/B diagnostics'
    ``--parent`` and ``--profile`` builds are made), and a Riccati and a KKT
    variant."""
    import glob
    import os

    from diffmpc_tpu_torch.csrc import build
    from diffmpc_tpu_torch.diagnostics.ab_riccati_lanes import build_riccati

    build.load()
    kkt_sources = sorted(glob.glob(os.path.join(build.CSRC, "kkt*.cu")))
    libs = {
        "library": build.library_path(),
        "riccati_second": build_riccati(str(tmp_path), build.CSRC, (), "second")._name,
        "kkt_second": build.build_with(kkt_sources, str(tmp_path), (), "kkt_second")._name,
    }
    for key in (build.VariantKey("riccati", 5, 1), build.VariantKey("kkt", 5, 1)):
        build.load_variant(key)
        libs[key.name] = build.variant_path(key)
    assert {name: build.unique_symbols(path) for name, path in libs.items()} == {name: [] for name in libs}


def test_world_one_nccl_dryrun_equals_the_steps_without_a_mesh(device, tmp_path):
    """The dry run's ensemble step, fused solve, imitation steps and probe
    on a one-rank NCCL mesh, held by ``dryrun.check`` to the same without a
    mesh: equal exactly, with one launch of each kernel a step."""
    spec = dryrun.make_spec(device, B=4096, il_batch=256, il_steps=2)
    with world_one_mesh(tmp_path, device=device) as mesh:
        rec = dryrun.rank_dryrun(mesh, spec)
    report = dryrun.check([rec], dryrun.single_process(spec, device), spec)
    assert report["backend"] == "nccl" and report["solve_scenarios_bit_equal"] == 4096


@pytest.mark.parametrize("env", ["pendulum", "cartpole", "quadrotor", "acrobot", "vehicle"])
def test_one_robot_fused_solve_lanes_bit_equal(device, env):
    """The render example's one-robot solve (B=1, T=15, lqr_iter=8): the
    wrapper's one launch at 16 lanes, finite and in the box; every built
    lane count, with and without hoist_lin, bit-equal to one lane, cold and
    warm-started from the cold solve's controls shifted one step; the
    wrapper's result equal to its lane count's."""
    from chip_smoke import same_bits
    from diffmpc_tpu_torch.ops.cuda import ilqr as il

    args = one_robot_problem(env, device)
    eight = dict(lqr_iter=8, eps=1e-5)
    before = ilqr_solve_fused.launches
    got = ilqr_solve_fused(*args, **eight)
    torch.cuda.synchronize()
    assert ilqr_solve_fused.launches == before + 1 and ilqr_solve_fused.last_lanes == 16
    assert bool(torch.isfinite(got.xs).all()) and bool(((got.us >= args[4]) & (got.us <= args[5])).all())
    env_k = il.kernel_env(args[3])
    warm = torch.cat([got.us[1:], got.us[-1:]], 0)
    for u_init in (None, warm):
        runs = {(L, hoist): il.run_staged(il._cuda_launcher(device, env_k, hoist), *args, u_init=u_init, lanes=L,
                                          hoist_lin=hoist, **eight)
                for hoist in (False, True) for L in il.ILQR_LANES}
        one = runs[(1, False)]
        for key, res in runs.items():
            assert all(same_bits(a, b) for a, b in zip(res, one)), key
        if u_init is None:
            assert all(same_bits(a, b) for a, b in zip(got, runs[(16, False)]))


def _variant_problem(case: str, device, B: int = 48, T: int = 10):
    """The fused solve's inputs of a variant: a zoo env's golden recipe
    (torch_zoo_cases), the slew penalty's wrap of the pendulum (4, 1) or the
    vehicle (6, 2) (the inner start with a carried control in front, the
    goal cost on the inner state, a slew weight of 1 and the inner box), or
    the (6, 3) MLP of scripts/ab_pnqp_enum3.py."""
    from torch_zoo_cases import kernel_problem

    from diffmpc_tpu_torch.models import CtrlPassthroughDynamics

    if case in ("cartpole", "vehicle", "quadrotor", "acrobot"):
        return tuple(a.to(device=device) for a in kernel_problem(case, B, T, torch.float32, seed=1407))
    if case == "nn63":
        gen = torch.Generator(device=device).manual_seed(0)
        nn = NNDynamics.init(6, 3, hidden=(16, 16), residual=True, device=device, generator=gen)
        x0 = torch.rand((B, 6), generator=gen, device=device) * 1.6 - 0.8
        C = torch.diag(torch.tensor([1.0] * 6 + [0.02] * 3, device=device)).expand(T, B, 9, 9)
        c = torch.tensor([0.0] * 6 + [0.08] * 3, device=device).expand(T, B, 9)
        box = torch.full((T, B, 3), 0.5, device=device)
        return x0, C, c, nn, -box, box
    if case == "pt_pendulum":
        from diffmpc_tpu_torch.diagnostics.ab_ilqr_lanes import problem

        x0, C_i, c_i, inner, lo, hi = problem(tdm.models.PendulumDx.default(device="cpu"), B, T, "cpu")
    else:
        x0, C_i, c_i, inner, lo, hi = kernel_problem("vehicle", B, T, torch.float32, seed=1408)
    n_i, m = inner.n_state, inner.n_ctrl
    n = n_i + m
    q = torch.cat([torch.zeros(m), torch.diagonal(C_i[0, 0])[:n_i], torch.diagonal(C_i[0, 0])[n_i:]])
    Cm = torch.diag(q)
    for i in range(m):
        Cm[i, i] += 1.0
        Cm[n + i, n + i] += 1.0
        Cm[i, n + i] = Cm[n + i, i] = -1.0
    c = torch.cat([torch.zeros(m), c_i[0, 0]])
    x = torch.cat([torch.rand((B, m), generator=torch.Generator().manual_seed(1409)) * 0.2 - 0.1, x0], -1)
    dyn = CtrlPassthroughDynamics(inner=inner.to(device=device), n_ctrl=m)
    return (x.to(device), Cm.to(device).expand(T, B, n + m, n + m), c.to(device).expand(T, B, n + m), dyn,
            lo.to(device), hi.to(device))


VARIANT_CASES = ["cartpole", "vehicle", "quadrotor", "acrobot", "pt_pendulum", "pt_vehicle", "nn63"]


@pytest.mark.parametrize("case", VARIANT_CASES)
def test_variant_shared_sweep_lanes_bit_equal_and_match_plain(device, case):
    """A fused-solve variant (at 16 lanes the group shares each step's
    Riccati arithmetic and linearizes in rounds): two iterations held
    against the plain version by chip_smoke's witness rule (the float64
    plain solve on the CPU as the witness; the box QP's ties at m >= 2);
    every built lane count, with and without ``hoist_lin``, bit-equal to
    one lane over three iterations, cold and warm-started from the cold
    solve's controls shifted one step."""
    from chip_smoke import same_bits, witnessed_agreement
    from diffmpc_tpu_torch.ops.cuda import ilqr as il

    args = _variant_problem(case, device)
    env = il.kernel_env(args[3])
    assert il.env_variant_key(env, "ilqr") is not None
    two = dict(lqr_iter=2, eps=1e-5)
    exact = ilqr_solve_plain(*(a.to(dtype=torch.float64, device="cpu") for a in args), **two)
    witnessed_agreement(case, ilqr_solve_fused(*args, **two), ilqr_solve_plain(*args, **two), exact, ties=env.m >= 2)
    three = dict(lqr_iter=3, eps=1e-5, decay=0.8)
    cold = il.run_staged(il._cuda_launcher(device, env, False), *args, **three)
    for u_init in (None, torch.cat([cold.us[1:], cold.us[-1:]], 0)):
        runs = {(L, hoist): il.run_staged(il._cuda_launcher(device, env, hoist), *args, u_init=u_init, lanes=L,
                                          hoist_lin=hoist, **three)
                for hoist in (False, True) for L in il.ILQR_LANES}
        one = runs[(1, False)]
        for key, res in runs.items():
            assert all(same_bits(a, b) for a, b in zip(res, one)), key


def test_variant_keys_fit_the_cards_shared_memory(device):
    """Every fused-solve variant key that the repo's paths build (the zoo's,
    the passthrough wraps', the (6, 3) MLP's under each box-QP mode, the
    pendulum's simplified update) at every lane count, with and without the
    pre-pass: its shared memory a block within the card's opt-in limit and
    at least one block an SM (``diffmpc_ilqr_variant_occupancy``)."""
    from diffmpc_tpu_torch.csrc import build
    from diffmpc_tpu_torch.diagnostics import ab_ilqr_lanes as ab
    from diffmpc_tpu_torch.ops.cuda import ilqr as il

    keys = list(dict.fromkeys(ab.case_key(case) for case in ab.VARIANT_CASES))
    build.build_variants(keys)
    props = torch.cuda.get_device_properties(device)
    limit = getattr(props, "shared_memory_per_block_optin", 227 * 1024)
    for key in keys:
        lib = build.load_variant(key)
        for hoist in (False, True):
            for L, occ in ab.occupancy(lib, il.ILQR_LANES, hoist).items():
                assert occ["smem_block_bytes"] <= limit and occ["blocks_per_sm"] >= 1, (key.name, L, hoist, occ)
