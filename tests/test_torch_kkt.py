"""The port's KKT backward (plain version) and its differentiable fixed
point against the JAX package's, on the same inputs.

- ``kkt_backward_plain`` against JAX's composite backward
  ``_kkt_backward_impl`` (``use_pallas=False``) and against its Pallas
  kernel ``kkt_backward_fused`` in interpret mode, on the residual recipe
  of tests/test_pallas_kkt.py, with a short shape fuzz;
- the CUDA kernel's source (``csrc/kkt.cuh``) built for the host with g++,
  its scenarios run by groups of 16 lanes one lane after another
  (``HostLanes``), against the same Pallas kernel in interpret mode;
- ``torch.autograd.grad`` through the port's ``lqr_fixed_point`` against
  ``jax.grad`` through JAX's, for all five of ``(x_init, C, c, F, f)``.

Tolerance: rtol = atol = 3e-5, the JAX file's own bound for the fused
kernel against the composite (both compute in float32).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffmpc_tpu.ops.lqr_step import LqrSpec as JaxLqrSpec  # noqa: E402
from diffmpc_tpu.ops.lqr_step import _kkt_backward_impl  # noqa: E402
from diffmpc_tpu.ops.lqr_step import lqr_fixed_point as jax_fixed_point  # noqa: E402
from diffmpc_tpu.ops.pallas.kkt import kkt_backward_fused as jax_kkt_fused  # noqa: E402
from diffmpc_tpu.utils import batch as jbatch  # noqa: E402
from diffmpc_tpu_torch.csrc import build  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.kkt import (  # noqa: E402
    _KktArgs,
    kkt_backward_fused,
    kkt_backward_plain,
    run_staged_kkt,
)
from diffmpc_tpu_torch.ops.lqr_step import LqrSpec, lqr_fixed_point  # noqa: E402
from diffmpc_tpu_torch.utils.batch import bger, btrans  # noqa: E402
from torch_parity import kernel_inputs, random_residuals  # noqa: E402

TOL = dict(rtol=3e-5, atol=3e-5)
NAMES = ("dx_init", "dC", "dc", "dF", "df")


def jax_composite(res, n):
    spec = JaxLqrSpec(n_state=n, constrained=True, use_pallas=False)
    j = {k: jnp.asarray(v) for k, v in res.items()}
    T, B = res["C"].shape[:2]
    resid = (j["x_star"][0], j["C"], j["c"], j["F"], jnp.zeros((T, B, n), jnp.float32),
             j["x_star"], j["u_star"], j["lo"], j["hi"])
    return [np.asarray(a) for a in _kkt_backward_impl(spec, resid, (j["gx"], j["gu"]))[:5]]


def plain(res, **kw):
    return [a.numpy() for a in kkt_backward_plain(*map(torch.tensor, kernel_inputs(res)), reg=1e-7, **kw)]


def assert_close(got, want, msg=""):
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, err_msg=f"{name} {msg}", **TOL)


@pytest.mark.parametrize("n,m,n_tight", [(3, 1, 0), (3, 1, 40), (3, 2, 60)])
def test_plain_matches_jax_composite_and_pallas_kernel(n, m, n_tight):
    rng = np.random.default_rng(800 + n * 10 + m)
    res = random_residuals(rng, 8, 24, n, m, n_tight)
    ins = kernel_inputs(res)
    if n_tight:
        assert ins[-1].any()
    got = plain(res)
    assert_close(got, jax_composite(res, n), "vs composite")
    fused = jax_kkt_fused(*map(jnp.asarray, ins), reg=1e-7, interpret=True)
    assert_close(got, [np.asarray(a) for a in fused], "vs Pallas kernel")


# The resident kernel's group of 16 lanes at (3, 1), built for the host: the
# lanes of each scenario's group run one after another (lanes.cuh, HostLanes).
HOST_KKT16 = r"""
#include <vector>

#include "kkt.cuh"

extern "C" int diffmpc_kkt_backward_l16_host(const KktArgs* a) {
  std::vector<float> slots(kkt_group_floats<3, 1, 16, true>(a->T) + 1);
  const HostLanes<16> g{slots.data()};
  for (int b = 0; b < a->B; ++b) kkt_backward_group<3, 1, false, true>(*a, g, b);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_kkt16(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of the kernel header needs it")
    d = tmp_path_factory.mktemp("kkt16")
    (d / "kkt16.cpp").write_text(HOST_KKT16)
    so = d / "libkkt16.so"
    proc = subprocess.run([gxx, "-O2", "-std=c++17", "-fPIC", "-shared", "-I", build.CSRC, "-o", str(so),
                           str(d / "kkt16.cpp")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    fn = ctypes.CDLL(str(so)).diffmpc_kkt_backward_l16_host
    fn.argtypes, fn.restype = [ctypes.POINTER(_KktArgs)], ctypes.c_int

    def launch(args, n, m):
        assert (n, m) == (3, 1) and fn(args) == 0

    return launch


def test_host_lane_kernel_matches_the_pallas_kernel(host_kkt16):
    """The KKT kernel's source at 16 lanes a scenario, K, k and p on chip,
    on the seeded inputs of the tight case above, against the JAX Pallas
    kernel in interpret mode."""
    res = random_residuals(np.random.default_rng(800 + 3 * 10 + 1), 8, 24, 3, 1, 40)
    ins = kernel_inputs(res)
    got = run_staged_kkt(host_kkt16, *map(torch.tensor, ins), reg=1e-7, lanes=16)
    fused = jax_kkt_fused(*map(jnp.asarray, ins), reg=1e-7, interpret=True)
    assert_close([a.numpy() for a in got], [np.asarray(a) for a in fused], "16 lanes vs Pallas kernel")


@pytest.mark.parametrize("seed", range(4))
def test_plain_shape_fuzz(seed):
    """Random (T, n, m, tight share) against the JAX composite, down to
    T=1, n=1 and m >= n."""
    rng = np.random.default_rng(900 + seed)
    T, n, m = int(rng.integers(1, 10)), int(rng.integers(1, 6)), int(rng.integers(1, 4))
    n_tight = int(rng.integers(0, max(1, T * 24 * m // 4)))
    res = random_residuals(rng, T, 24, n, m, n_tight)
    assert_close(plain(res), jax_composite(res, n), f"T={T} n={n} m={m} n_tight={n_tight}")


def test_plain_gradients_have_the_outer_product_form():
    """dC = 1/2 (p tau' + tau p') with p = dc, so dC is symmetric; dF and
    df vanish at the last step, where the multipliers lam_T = mu_T = 0."""
    res = random_residuals(np.random.default_rng(3), 6, 16, 3, 1, 10)
    _, _, _, _, tau, _ = map(torch.tensor, kernel_inputs(res))
    dx_init, dC, dc, dF, df = map(torch.tensor, plain(res))
    torch.testing.assert_close(dC, 0.5 * (bger(dc, tau) + bger(tau, dc)))
    torch.testing.assert_close(dC, btrans(dC))
    assert float(dF[-1].abs().max()) == 0.0 and float(df[-1].abs().max()) == 0.0
    assert dx_init.shape == (16, 3) and bool(dx_init.abs().max() > 0)


def test_batch_helpers_match_jax():
    rng = np.random.default_rng(4)
    x, y = rng.normal(size=(2, 5, 3)), rng.normal(size=(2, 5, 4))
    np.testing.assert_allclose(bger(torch.tensor(x), torch.tensor(y)).numpy(), np.asarray(jbatch.bger(x, y)))
    mat = rng.normal(size=(2, 3, 4))
    np.testing.assert_array_equal(btrans(torch.tensor(mat)).numpy(), np.asarray(jbatch.btrans(mat)))


def test_wrapper_takes_plain_version_on_cpu():
    res = random_residuals(np.random.default_rng(5), 5, 12, 3, 1, 8)
    ins = [torch.tensor(a) for a in kernel_inputs(res)]
    before = kkt_backward_fused.launches
    got = kkt_backward_fused(*ins)
    for g, w in zip(got, kkt_backward_plain(*ins)):
        assert torch.equal(g, w)
    assert kkt_backward_fused.launches == before  # nothing was launched
    with pytest.raises(ValueError, match="use_cuda=True"):
        kkt_backward_fused(*ins, use_cuda=True)
    # float64 in, float64 out, and the backward computes in float64: within
    # float32 rounding of the float32 backward, and not that backward cast
    got64 = kkt_backward_fused(*[a.double() if a.is_floating_point() else a for a in ins])
    for g, w in zip(got64, got):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6)
    assert not torch.equal(got64[3], got[3].double())


def test_kernel_staging_rejects_what_the_kernel_does_not_take():
    res = random_residuals(np.random.default_rng(6), 4, 8, 3, 1)
    C, c, F, r, tau, tight = [torch.tensor(a) for a in kernel_inputs(res)]

    def never(*_):
        raise AssertionError("launched")

    with pytest.raises(TypeError, match="float32"):
        run_staged_kkt(never, C.double(), c, F, r, tau, tight)
    with pytest.raises(TypeError, match="bool"):
        run_staged_kkt(never, C, c, F, r, tau, tight.float())
    with pytest.raises(ValueError, match="F must be"):
        run_staged_kkt(never, C, c, F[..., :3], r, tau, tight)
    with pytest.raises(ValueError, match="tight must be"):
        run_staged_kkt(never, C, c, F, r, tau, tight[:, :4])


@pytest.mark.parametrize("n_tight", [0, 30])
def test_fixed_point_gradients_match_jax(n_tight):
    """autograd through the port's lqr_fixed_point against jax.grad through
    JAX's, for a loss that weights every trajectory entry."""
    T, B, n, m = 6, 16, 3, 1
    rng = np.random.default_rng(810 + n_tight)
    res = random_residuals(rng, T, B, n, m, n_tight)
    x_init = res["x_star"][0].copy()
    f = rng.normal(size=(T, B, n)).astype(np.float32)
    wx, wu = res["gx"], res["gu"]  # the loss's weights are the incoming gradient

    def jloss(x0, C, c, F, f_):
        spec = JaxLqrSpec(n_state=n, constrained=True, use_pallas=False)
        xs, us = jax_fixed_point(spec, x0, C, c, F, f_, jnp.asarray(res["x_star"]),
                                 jnp.asarray(res["u_star"]), jnp.asarray(res["lo"]), jnp.asarray(res["hi"]))
        return jnp.sum(xs * wx) + jnp.sum(us * wu)

    want = jax.grad(jloss, argnums=range(5))(*map(jnp.asarray, (x_init, res["C"], res["c"], res["F"], f)))

    leaves = [torch.tensor(a, requires_grad=True) for a in (x_init, res["C"], res["c"], res["F"], f)]
    xs, us = lqr_fixed_point(
        LqrSpec(n_state=n, constrained=True), *leaves, torch.tensor(res["x_star"]),
        torch.tensor(res["u_star"]), torch.tensor(-1.0), torch.tensor(1.0),
    )
    torch.testing.assert_close(xs, torch.tensor(res["x_star"]))  # the identity
    loss = (xs * torch.tensor(wx)).sum() + (us * torch.tensor(wu)).sum()
    got = torch.autograd.grad(loss, leaves)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
