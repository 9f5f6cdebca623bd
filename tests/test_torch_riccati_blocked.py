"""The port's depth-blocked Riccati sweep and its parallel-in-time algebra
against the JAX package's, on the same inputs.

- ``riccati_backward_blocked_plain`` against the JAX Pallas kernel
  ``riccati_backward_blocked_pallas`` in interpret mode (the recipe of
  tests/test_pallas_riccati.py: T=8, B=64) at (n, m) in {(3, 1), (4, 2)} and
  block 2 and 4: ``K, k`` within ``1e-5 * max(1, max|JAX|)``. The two run
  the same float32 algorithm in the same entry order; what is left is the
  gains step's Q form (the port shares the serial sweep's, which takes
  ``Qux`` from the mirrored upper triangle; the TPU kernel sums it from the
  lower one) and summation rounding;
- the plain version against the port's serial sweep in free mode within
  ``5e-4 * max(1, max|serial|)``, the JAX package's own bound between its
  blocked and serial sweeps;
- ``ops/assoc_riccati.py`` against the JAX module in float64 on the shapes
  of tests/test_assoc_riccati.py within 1e-9: the same pairs combine in the
  same order (the reverse scan is written out with
  ``jax.lax.associative_scan``'s recursion); JAX's ``einsum`` and the port's
  elementwise products sum in other orders;
- the entry-form algebra of the kernel against the matrix form in float64,
  and ``ops/smallchol.py``'s new solvers against JAX's.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffmpc_tpu.ops import assoc_riccati as jar  # noqa: E402
from diffmpc_tpu.ops import smallchol as jsc  # noqa: E402
from diffmpc_tpu.ops.pallas.riccati_blocked import riccati_backward_blocked_pallas  # noqa: E402
from diffmpc_tpu_torch.ops import assoc_riccati as tar  # noqa: E402
from diffmpc_tpu_torch.ops import smallchol as tsc  # noqa: E402
from diffmpc_tpu_torch.ops.cuda import riccati_blocked as rb  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.riccati import riccati_backward_plain  # noqa: E402
from oracles import random_lqr_problem  # noqa: E402
from diffmpc_tpu_torch.parallel import shard_batch  # noqa: E402
from torch_dist_cases import world_one_mesh  # noqa: E402


@functools.partial(jax.jit, static_argnames=("n", "block"))
def jax_blocked(C, c, F, f, *, n, block):
    return riccati_backward_blocked_pallas(C, c, F, f, n, block=block, interpret=True)


jax_assoc = jax.jit(jar.riccati_backward_assoc, static_argnums=(4,))
jax_assoc_blocked = jax.jit(jar.riccati_backward_blocked, static_argnums=(4,), static_argnames=("n_blocks",))


def _inputs(n, m, T=8, B=64, seed=0):
    rng = np.random.default_rng(7 + n * 10 + m + seed)
    return [a.astype(np.float32) for a in random_lqr_problem(rng, T, B, n, m)[:4]]


@pytest.mark.parametrize("block", [2, 4])
@pytest.mark.parametrize("n,m", [(3, 1), (4, 2)])
def test_plain_matches_jax_blocked_kernel(n, m, block):
    arrays = _inputs(n, m)
    want = jax_blocked(*map(jnp.asarray, arrays), n=n, block=block)
    got = rb.riccati_backward_blocked_plain(*map(torch.tensor, arrays), n, block=block)
    for name in ("K", "k"):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.shape == w.shape and g.dtype == np.float32, name
        np.testing.assert_allclose(g, w, atol=1e-5 * max(1.0, np.abs(w).max()), rtol=0, err_msg=name)
    assert bool(got.free_mask.all()) and not bool(got.n_qp_iter.any())


@pytest.mark.parametrize("with_f", [False, True], ids=["f_none", "with_f"])
@pytest.mark.parametrize("block", [2, 4])
@pytest.mark.parametrize("n,m", [(3, 1), (3, 2), (4, 1), (4, 2)])
def test_plain_matches_serial_free_sweep(n, m, block, with_f):
    C, c, F, f = map(torch.tensor, _inputs(n, m, T=12, B=33, seed=1))
    f = f if with_f else None
    got = rb.riccati_backward_blocked(C, c, F, f, n, block=block)  # CPU tensors: the plain version
    want = riccati_backward_plain(C, c, F, f, n)
    for name in ("K", "k"):
        g, w = getattr(got, name), getattr(want, name)
        torch.testing.assert_close(g, w, atol=5e-4 * max(1.0, float(w.abs().max())), rtol=0)


def test_plain_keeps_the_input_dtype():
    C, c, F, f = (torch.tensor(a, dtype=torch.float64) for a in _inputs(3, 1, T=4, B=5))
    out = rb.riccati_backward_blocked_plain(C, c, F, f, 3, block=2)
    assert out.K.dtype == out.k.dtype == torch.float64
    assert out.free_mask.dtype == torch.bool and out.n_qp_iter.dtype == torch.int32


def test_blocked_validates_block_and_horizon():
    C, c, F, f = map(torch.tensor, _inputs(3, 1, T=6, B=8))
    for fn in (rb.riccati_backward_blocked, rb.riccati_backward_blocked_plain, rb.riccati_backward_blocked_cuda):
        with pytest.raises(ValueError, match="must evenly divide"):
            fn(C, c, F, f, 3, block=4)
        with pytest.raises(ValueError, match="block must be 2 or 4"):
            fn(C, c, F, f, 3, block=3)
    with pytest.raises(ValueError, match="block must be 2 or 4"):
        rb.run_staged_blocked(lambda *a: None, C, c, F, f, 3, block=8)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches or raises: it never runs the plain
    version for tensors on the CPU, and counts nothing then."""
    C, c, F, f = map(torch.tensor, _inputs(3, 1, T=4, B=8))
    before = rb.riccati_backward_blocked_cuda.launches
    with pytest.raises(ValueError, match="use_cuda"):
        rb.riccati_backward_blocked_cuda(C, c, F, f, 3, block=2)
    rb.riccati_backward_blocked(C, c, F, f, 3, block=2)
    assert rb.riccati_backward_blocked_cuda.launches == before


def test_staging_checks_dtype_and_scratch_size():
    C, c, F, f = map(torch.tensor, _inputs(3, 1, T=8, B=8))
    with pytest.raises(TypeError, match="float32"):
        rb.run_staged_blocked(lambda *a: None, C.double(), c, F, f, 3, block=2)
    seen = {}
    rb.run_staged_blocked(lambda args, n, m: seen.update(args=args._obj, n=n, m=m), C, c, F, None, 3, block=4)
    assert (seen["n"], seen["m"], seen["args"].block) == (3, 1, 4)
    assert seen["args"].ric.f is None and seen["args"].ric.T == 8 and seen["args"].ric.B == 8
    # no device scratch: the kernel keeps its elements and boundary values on
    # chip, and the args name only the inputs, the outputs and D
    assert [name for name, _ in rb._BlockedArgs._fields_] == ["ric", "block"]
    assert not hasattr(rb, "scratch_rows")


# ---------------------------------------------------------------------------
# The parallel-in-time algebra, matrix form (float64, the JAX tests' x64).
# ---------------------------------------------------------------------------


def _f64(rng, T, B, n, m):
    arrays = random_lqr_problem(rng, T, B, n, m)[:4]
    return [jnp.asarray(a) for a in arrays], [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("T,n,m", [(2, 3, 2), (7, 3, 1), (32, 4, 2), (65, 2, 2)])
def test_assoc_matches_jax(T, n, m):
    jargs, targs = _f64(np.random.default_rng(300 + T), T, 8, n, m)
    want = jax_assoc(*jargs, n)
    got = tar.riccati_backward_assoc(*targs, n)
    for name in ("K", "k"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), atol=1e-9, rtol=0)
    assert bool(got.free_mask.all()) and got.K.dtype == torch.float64


@pytest.mark.parametrize("T,n,m,D", [(16, 3, 1, 4), (64, 3, 2, 8), (120, 2, 1, 12), (32, 4, 2, 32)])
def test_blocked_matrix_form_matches_jax(T, n, m, D):
    jargs, targs = _f64(np.random.default_rng(600 + T), T, 4, n, m)
    want = jax_assoc_blocked(*jargs, n, n_blocks=D)
    got = tar.riccati_backward_blocked(*targs, n, n_blocks=D)
    for name in ("K", "k"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), atol=1e-9, rtol=0)


def test_assoc_f_none_and_the_serial_sweep():
    """f = None is f = 0, and the parallel-in-time gains are the serial
    sweep's (float64 here against the float32 plain sweep's rounding)."""
    _, (C, c, F, f) = _f64(np.random.default_rng(11), 9, 6, 3, 2)
    zero = tar.riccati_backward_assoc(C, c, F, torch.zeros_like(f), 3)
    none = tar.riccati_backward_assoc(C, c, F, None, 3)
    torch.testing.assert_close(none.K, zero.K, atol=0, rtol=0)
    serial = riccati_backward_plain(C, c, F, f, 3)
    torch.testing.assert_close(tar.riccati_backward_assoc(C, c, F, f, 3).K, serial.K, atol=1e-5, rtol=0)


def test_blocked_matrix_form_requires_divisible_horizon():
    _, targs = _f64(np.random.default_rng(601), 10, 2, 3, 1)
    with pytest.raises(ValueError, match="divisible"):
        tar.riccati_backward_blocked(*targs, 3, n_blocks=4)


def test_time_sharded_raises_until_parallel_is_ported(tmp_path):
    """The time-sharded sweep on a ``"time"`` mesh of one rank (a gloo group
    of this process), given its shard of the horizon, is the blocked sweep of
    one block; on a mesh named otherwise it raises."""
    _, targs = _f64(np.random.default_rng(501), 8, 2, 3, 1)
    with world_one_mesh(tmp_path, axis="time") as mesh:
        got = tar.riccati_backward_time_sharded(mesh, *shard_batch(mesh, targs, 0), 3)
    want = tar.riccati_backward_blocked(*targs, 3, n_blocks=1)
    for name in ("K", "k"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), atol=1e-12, rtol=0)
    assert bool(got.free_mask.all()) and got.K.shape == (8, 2, 1, 3)
    with world_one_mesh(tmp_path) as mesh, pytest.raises(ValueError, match="'time'"):
        tar.riccati_backward_time_sharded(mesh, *targs, 3)


def _elements(seed, n, m, B=16):
    """Two steps' elements from a random problem: matrix form (float64)."""
    _, (C, c, F, f) = _f64(np.random.default_rng(seed), 2, B, n, m)
    els = tar._build_elements(C, c, F, f, n, reg=1e-9, zero_last=False)
    return [tuple(e[t] for e in els) for t in range(2)]


def _entries(e, n):
    """Matrix-form element -> entry form: lists of (B,) tensors."""
    A, b, C, eta, J = e

    def mat(x):
        return [[x[:, i, j] for j in range(n)] for i in range(n)]

    return mat(A), [b[:, i] for i in range(n)], mat(C), [eta[:, i] for i in range(n)], mat(J)


def _matrix(e):
    """Entry-form element -> matrix form."""
    A, b, C, eta, J = e

    def mat(x):
        return torch.stack([torch.stack(row, -1) for row in x], -2)

    return mat(A), torch.stack(b, -1), mat(C), torch.stack(eta, -1), mat(J)


@pytest.mark.parametrize("n,m", [(3, 1), (4, 2), (2, 2)])
def test_entry_form_algebra_matches_matrix_form(n, m):
    """The kernel's entry-form combine and element build against the matrix
    form of ops/assoc_riccati.py, on real elements (C, J PSD)."""
    e0, e1 = _elements(40 + n + m, n, m)
    got = _matrix(rb._combine_entries(_entries(e0, n), _entries(e1, n), n))
    for g, w in zip(got, tar._combine(e0, e1)):
        torch.testing.assert_close(g, w, atol=1e-12, rtol=1e-12)
    # one step's element
    _, (C, c, F, f) = _f64(np.random.default_rng(41), 1, 16, n, m)
    got = _matrix(rb._build_element_entries(C[0].permute(1, 2, 0), c[0].T, F[0].permute(1, 2, 0), f[0].T, n, m, 1e-9))
    for g, w in zip(got, tar._build_elements(C, c, F, f, n, reg=1e-9, zero_last=False)):
        torch.testing.assert_close(g, w[0], atol=1e-12, rtol=1e-12)


def test_entry_solve_matches_gauss_jordan():
    """The kernel's elimination order (forward, then back substitution) and
    the matrix form's Gauss-Jordan give the same solutions."""
    rng = np.random.default_rng(5)
    n, k, B = 4, 3, 10
    A = torch.tensor(np.eye(n) + 0.3 * rng.normal(size=(B, n, n)))
    b = torch.tensor(rng.normal(size=(B, n, k)))
    want = tsc.solve_general_small(A, b)
    cols = rb._solve_general_entries([[A[:, i, j] for j in range(n)] for i in range(n)],
                                     [[b[:, i, c] for i in range(n)] for c in range(k)], n)
    got = torch.stack([torch.stack(col, -1) for col in cols], -1)
    torch.testing.assert_close(got, want, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("m", [1, 2, 4])
def test_smallchol_solvers_match_jax(m):
    rng = np.random.default_rng(20 + m)
    L = rng.normal(size=(6, m, m))
    A = L @ np.swapaxes(L, -1, -2) + m * np.eye(m)
    G = np.eye(m) + 0.2 * rng.normal(size=(6, m, m))
    b = rng.normal(size=(6, m, 3))
    for jf, tf, M in ((jsc.solve_psd_small, tsc.solve_psd_small, A), (jsc.solve_general_small, tsc.solve_general_small, G)):
        want = np.asarray(jf(jnp.asarray(M), jnp.asarray(b)))
        got = tf(torch.tensor(M), torch.tensor(b)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=1e-12)
    np.testing.assert_allclose(
        tsc.solve_psd_small(torch.tensor(A), torch.tensor(b), jitter=1e-3).numpy(),
        np.asarray(jsc.solve_psd_small(jnp.asarray(A), jnp.asarray(b), jitter=1e-3)), atol=1e-12, rtol=1e-12,
    )
