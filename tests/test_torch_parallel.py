"""The port's data-parallel training step and sharding helpers against the
JAX package's, in one process.

- ``make_dp_train_step`` in the four configurations of
  tests/torch_dist_cases.py (shared params, per-scenario params, a mixed
  pytree, a per-scenario task payload; float64, eps=0 and
  ``not_improved_lim=10**6``, the recipe of tests/test_sharding.py:22-45)
  against JAX's step without a mesh and on the conftest's 8-device mesh:
  params within 1e-7 and the loss within rtol 1e-9, the JAX package's own
  bounds between its modes; the gradient norm within rtol 1e-6. The port's
  step on a mesh of one rank (a gloo group of this process) equals its step
  without one exactly: one rank's ``all_reduce`` is the identity.
- The axes validation errors of tests/test_sharding.py:415-432.
- ``shard_batch`` and ``replicate`` at world size 1.
- The probe kernel's plain version against the JAX body of
  tests/test_pallas_sharding.py:209-215 (copied here) under
  ``shard_map(check_vma=False)`` in interpret mode, at 8 devices (a shard of
  2) and 2 devices (a shard of 8): bit-equal.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import diffmpc_tpu as jdm  # noqa: E402
import diffmpc_tpu_torch as tdm  # noqa: E402
from diffmpc_tpu.models import PendulumDx as JaxPendulumDx  # noqa: E402
from diffmpc_tpu.parallel import init_train_state as jax_init_train_state  # noqa: E402
from diffmpc_tpu.parallel import make_dp_train_step as jax_make_dp_train_step  # noqa: E402
from diffmpc_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from diffmpc_tpu.parallel import shard_batch as jax_shard_batch  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.shard_probe import shard_probe  # noqa: E402
from diffmpc_tpu_torch.parallel import (  # noqa: E402
    BATCH_AXIS,
    batch_sharding,
    make_dp_train_step,
    make_mesh,
    replicate,
    replicated,
    shard_batch,
)
from torch_dist_cases import AXES, CONFIGS, KNOBS, inputs, port_step, world_one_mesh  # noqa: E402

DATA = inputs()


@functools.lru_cache(maxsize=None)
def jax_result(name: str, sharded: bool) -> dict:
    """One step of configuration ``name`` with the JAX package, without a
    mesh or on the 8-device mesh: the stats and the params as numpy."""
    dx = JaxPendulumDx.default(jnp.float64)
    q, p = dx.get_true_obj()
    cost = jdm.QuadCost(jnp.diag(q), p)
    if name == "mixed":
        def make_problem(prm):
            return cost, dx.replace(params=prm["dyn"] + prm["bias"])
    elif name == "task":
        def make_problem(prm, task):
            return jdm.QuadCost(cost.C, task), dx.replace(params=prm)
    else:
        def make_problem(prm):
            return cost, dx.replace(params=prm)
    opt = optax.sgd(1e-2)
    mesh = jax_make_mesh() if sharded else None
    kw = dict(task_batch_axes=1) if name == "task" else {}
    step = jax_make_dp_train_step(jdm.MPCConfig(**KNOBS, dtype=jnp.float64), make_problem, opt, mesh, -2.0, 2.0,
                                  params_batch_axes=AXES[name], **kw)
    params = jax.tree.map(jnp.asarray, DATA["params"][name])
    x, u, task = (jnp.asarray(DATA[k]) for k in ("x", "u", "task"))
    if sharded:
        axes = AXES[name]
        params = jax.tree.map(lambda a, leaf: jax_shard_batch(mesh, leaf, 0) if a == 0 else leaf,
                              axes, params, is_leaf=lambda a: a is None) if isinstance(axes, dict) else \
            (jax_shard_batch(mesh, params, 0) if axes == 0 else params)
        x, u, task = jax_shard_batch(mesh, x, 0), jax_shard_batch(mesh, u, 1), jax_shard_batch(mesh, task, 1)
    state, stats = step(jax_init_train_state(params, opt), x, u, *([task] if name == "task" else []))
    out = {k: float(v) for k, v in stats._asdict().items()}
    out["params"] = jax.tree.map(np.asarray, state.params)
    return out


def assert_steps_match(got: dict, want: dict, loss_rtol: float, params_atol: float, norm_rtol: float) -> None:
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=norm_rtol)
    for g, w in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(want["params"])):
        np.testing.assert_allclose(g, w, atol=params_atol, rtol=0)


@pytest.mark.parametrize("name", CONFIGS)
def test_dp_step_matches_jax_without_and_with_a_mesh(name, tmp_path):
    got = port_step(name, DATA)
    for sharded in (False, True):
        assert_steps_match(got, jax_result(name, sharded), 1e-9, 1e-7, 1e-6)
    with world_one_mesh(tmp_path) as mesh:
        on_mesh = port_step(name, DATA, mesh)
    assert {k: v for k, v in on_mesh.items() if k != "params"} == {k: v for k, v in got.items() if k != "params"}
    for g, w in zip(jax.tree.leaves(on_mesh["params"]), jax.tree.leaves(got["params"])):
        np.testing.assert_array_equal(g, w)


def test_axes_validation_raises():
    """Axes leaves other than 0 / None for the params, and other than a
    non-negative int / None for the task, raise (tests/test_sharding.py:415-432),
    with a mesh or without."""
    config = tdm.MPCConfig(n_state=3, n_ctrl=1, T=4)
    sgd = functools.partial(torch.optim.SGD, lr=1e-2)
    for bad in (True, False, 1, {"dyn": True, "bias": False}):
        with pytest.raises(ValueError, match="params_batch_axes"):
            make_dp_train_step(config, lambda prm: None, sgd, params_batch_axes=bad)
    for bad in (True, -1, {"goal": True}):
        with pytest.raises(ValueError, match="task_batch_axes"):
            make_dp_train_step(config, lambda prm, task: None, sgd, task_batch_axes=bad)


def test_sharding_helpers_at_world_size_one(tmp_path):
    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh()
    x = torch.arange(24.0).reshape(2, 4, 3)
    with world_one_mesh(tmp_path) as mesh:
        assert (mesh.rank, mesh.size, mesh.axis) == (0, 1, BATCH_AXIS)
        got = shard_batch(mesh, {"x": x, "rows": x[0]}, 0)
        assert torch.equal(got["x"], x) and torch.equal(got["rows"], x[0])
        assert torch.equal(shard_batch(mesh, x, 1), x)
        assert torch.equal(replicate(mesh, x), x)
        assert repr(batch_sharding(mesh, 1, 3)) == "Shard(dim=1)" and repr(replicated(mesh)) == "Replicate()"
        with pytest.raises(ValueError):
            batch_sharding(mesh, 2, 2)


def _kern(x_ref, o_ref):
    """tests/test_pallas_sharding.py:209-215."""
    def body(i, c):
        return c + x_ref[i]  # dynamic-index read: varying ref, replicated i

    o_ref[...] = jnp.broadcast_to(jax.lax.fori_loop(0, 3, body, x_ref[0]), o_ref.shape)


@pytest.mark.parametrize("n_dev", [8, 2])
def test_probe_plain_matches_the_jax_body_on_each_shard(n_dev):
    from jax.experimental import pallas as pl

    x = np.arange(16, dtype=np.float32) ** 1.5
    mesh = JaxMesh(np.asarray(jax.devices("cpu")[:n_dev]), (BATCH_AXIS,))

    def f(xl):
        return pl.pallas_call(_kern, out_shape=jax.ShapeDtypeStruct(xl.shape, xl.dtype), interpret=True)(xl)

    g = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P(BATCH_AXIS),), out_specs=P(BATCH_AXIS), check_vma=False))
    want = np.asarray(g(jnp.asarray(x)))
    L = 16 // n_dev
    got = np.concatenate([shard_probe(torch.tensor(x[r * L:(r + 1) * L])).numpy() for r in range(n_dev)])
    np.testing.assert_array_equal(got, want)
    # the clamp: a shard of 2 reads its second element twice
    assert got[0] == (x[0] + x[0] + x[1] + (x[1] if L == 2 else x[2]))
