"""``diffmpc_tpu_torch.checkpoint`` and ``convert.train_state_from_jax``.

Save, ``latest_step`` and pruning; an interrupted save's temporary never
taken as the latest step; restoring a tensor's and a ``{"w": [...], "b":
[...]}`` tree's params in place with Adam's moments and step; a tree, shape
or dtype that differs raising. A JAX run's state continues in the port:
two JAX ``make_dp_train_step`` steps of il_pendulum's problem (B=16, T=10,
``lqr_iter=5``), converted, then one more Adam update on each side from one
gradient, the params within 1e-5 relative: past Adam's first step, whose
``lr * sign(g)`` would hide a wrong rule. A whole train step on each side
from the converted state, on the same expert controls, is held by the chaos
rule, by which this size's solves part.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diffmpc_tpu_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint  # noqa: E402
from diffmpc_tpu_torch.parallel import TrainState, init_train_state  # noqa: E402
from diffmpc_tpu_torch.utils.tree import tree_leaves  # noqa: E402

ADAM = functools.partial(torch.optim.Adam, lr=0.1)


def _trained(params, steps=2, seed=0):
    """A state over ``params`` after ``steps`` Adam steps on random
    gradients."""
    state = init_train_state(params, ADAM)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for leaf in tree_leaves(state.params):
            leaf.grad = torch.randn(leaf.shape, generator=gen, dtype=leaf.dtype)
        state.opt_state.step()
    return state


def _tree():
    return {"w": [torch.ones(3, 2), torch.zeros(2)], "b": [torch.full((2,), 0.5)]}


def test_save_latest_and_prune(tmp_path):
    state = _trained(torch.tensor([1.0, 2.0, 3.0]))
    assert latest_step(str(tmp_path / "none")) is None
    for step in (1, 2, 3, 4, 5):
        path = save_checkpoint(str(tmp_path), state, step, keep=3)
        assert os.path.basename(path) == f"step_{step}"
    assert latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4", "step_5"]


def test_a_temporary_is_never_the_latest(tmp_path):
    """A save cut before its rename leaves ``step_<N>.tmp-<pid>``, which is
    not a step; restore takes the newest finished one."""
    state = _trained(torch.tensor([1.0, 2.0]))
    save_checkpoint(str(tmp_path), state, 2)
    (tmp_path / "step_7.tmp-123").write_bytes(b"cut")
    (tmp_path / "step_x").write_bytes(b"")
    assert latest_step(str(tmp_path)) == 2
    like = init_train_state(torch.zeros(2), ADAM)
    restore_checkpoint(str(tmp_path), like)
    assert torch.equal(like.params.detach(), state.params.detach())
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty"), like)


@pytest.mark.parametrize("params", [torch.tensor([1.0, -2.0, 3.0]), _tree()], ids=["tensor", "tree"])
def test_restore_in_place_with_adam_state(params, tmp_path):
    """The restored params are the ``like`` state's own leaves (the optimizer
    holds them), with the saved values, Adam's moments and step; the next
    step equals the saved run's next step bit for bit."""
    state = _trained(params, steps=3)
    save_checkpoint(str(tmp_path), state, 3)
    like = init_train_state(params, ADAM)
    leaves = tree_leaves(like.params)
    got = restore_checkpoint(str(tmp_path), like, step=3)
    assert got is like
    for a, b, c in zip(tree_leaves(got.params), leaves, tree_leaves(state.params)):
        assert a is b and torch.equal(a, c)
    want, have = state.opt_state.state_dict(), like.opt_state.state_dict()
    for k, entry in want["state"].items():
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(have["state"][k][name], entry[name]), (k, name)
    for s in (state, like):
        for leaf in tree_leaves(s.params):
            leaf.grad = torch.ones_like(leaf)
        s.opt_state.step()
    for a, b in zip(tree_leaves(like.params), tree_leaves(state.params)):
        assert torch.equal(a, b)


def test_restore_keeps_the_runs_learning_rate(tmp_path):
    state = _trained(torch.tensor([1.0, 2.0]))
    save_checkpoint(str(tmp_path), state, 2)
    like = init_train_state(torch.zeros(2), functools.partial(torch.optim.Adam, lr=0.01))
    restore_checkpoint(str(tmp_path), like)
    assert like.opt_state.param_groups[0]["lr"] == 0.01


@pytest.mark.parametrize("other", [
    torch.zeros(4),  # shape
    torch.zeros(3, dtype=torch.float64),  # dtype
    {"w": torch.zeros(3)},  # tree
    [torch.zeros(3)],  # tree: a list where a tensor was
], ids=["shape", "dtype", "dict", "list"])
def test_restore_raises_on_a_mismatch(other, tmp_path):
    save_checkpoint(str(tmp_path), _trained(torch.zeros(3)), 1)
    like = init_train_state(other, ADAM)
    before = [leaf.detach().clone() for leaf in tree_leaves(like.params)]
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), like)
    for leaf, b in zip(tree_leaves(like.params), before):
        assert torch.equal(leaf.detach(), b)  # nothing copied


def test_restore_raises_on_a_tree_of_other_lengths(tmp_path):
    save_checkpoint(str(tmp_path), _trained(_tree()), 1)
    tree = _tree()
    tree["b"].append(torch.zeros(1))
    with pytest.raises(ValueError, match="tree"):
        restore_checkpoint(str(tmp_path), init_train_state(tree, ADAM))


def test_train_state_from_jax_continues_a_jax_run():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import optax

    from diffmpc_tpu import MPCConfig as JaxConfig
    from diffmpc_tpu import QuadCost as JaxCost
    from diffmpc_tpu.models import PendulumDx as JaxPendulum
    from diffmpc_tpu.parallel import generate_expert_data as jax_expert
    from diffmpc_tpu.parallel import init_train_state as jax_init
    from diffmpc_tpu.parallel import make_dp_train_step as jax_make_step
    from diffmpc_tpu_torch.convert import train_state_from_jax
    from diffmpc_tpu_torch.examples import il_pendulum
    from diffmpc_tpu_torch.parallel import make_dp_train_step

    args = il_pendulum.parse_args(["--cpu", "--batch", "16", "--horizon", "10", "--lqr-iter", "5"])
    b = il_pendulum.build(args, torch.device("cpu"))
    true_dx = JaxPendulum.default(jnp.float32)
    q, p = true_dx.get_true_obj()
    cost = JaxCost(jnp.diag(q), p)
    config = JaxConfig(n_state=3, n_ctrl=1, T=10, lqr_iter=5, eps=1e-5, exit_unconverged=False,
                       detach_unconverged=True, dtype=jnp.float32)
    x = jnp.asarray(b["x_init"].numpy())
    _, u_expert, _ = jax_expert(config, cost, true_dx, x, -2.0, 2.0)
    optimizer = optax.adam(args.lr)
    step = jax.jit(jax_make_step(config, lambda prm: (cost, true_dx.replace(params=prm)), optimizer, None,
                                 u_lower=-2.0, u_upper=2.0))
    state = jax_init(jnp.asarray(b["params0"].numpy()), optimizer)
    for _ in range(2):
        state, _ = step(state, x, u_expert)
    adam = functools.partial(torch.optim.Adam, lr=args.lr)
    port = train_state_from_jax(state.params, state.opt_state, adam, device="cpu")
    assert isinstance(port, TrainState)
    np.testing.assert_array_equal(port.params.detach().numpy(), np.asarray(state.params))
    (moments,) = port.opt_state.state_dict()["state"].values()
    assert float(moments["step"]) == 2.0
    np.testing.assert_array_equal(moments["exp_avg"].numpy(), np.asarray(state.opt_state[0].mu))
    np.testing.assert_array_equal(moments["exp_avg_sq"].numpy(), np.asarray(state.opt_state[0].nu))
    # the Adam rule past its first step: one more update on each side from
    # one gradient
    grad = jnp.asarray([0.3, -0.6, 0.15], jnp.float32)
    updates, _ = optimizer.update(grad, state.opt_state, state.params)
    want = np.asarray(optax.apply_updates(state.params, updates))
    port.params.grad = torch.tensor(np.asarray(grad))
    port.opt_state.step()
    np.testing.assert_allclose(port.params.detach().numpy(), want, rtol=1e-5, atol=0)
    # and a whole train step on each side, from the same state and expert
    # controls: at this size the solves part by the chaos rule (a converged
    # scenario's tie: tests/test_torch_examples.py), so the params are held
    # by its tolerance
    port = train_state_from_jax(state.params, state.opt_state, adam, device="cpu")
    state, _ = step(state, x, u_expert)
    port_step = make_dp_train_step(b["config"], b["make_problem"], adam, None, u_lower=-2.0, u_upper=2.0)
    port, _ = port_step(port, b["x_init"], torch.tensor(np.asarray(u_expert)))
    np.testing.assert_allclose(port.params.detach().numpy(), np.asarray(state.params), rtol=1e-3, atol=1e-3)
