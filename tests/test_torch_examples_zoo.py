"""The port's zoo examples against the JAX scripts, on the CPU.

il_quadrotor and il_acrobot run with the same flags in both packages
(``tests/torch_examples.py``) at ``--batch 16 --horizon 10 --lqr-iter 5
--steps 3``, their ``train.csv`` files and every step's params compared by
``torch_examples.compare_runs``. il_nn_dynamics draws its first weights from
``jax.random`` in JAX and from a ``torch.Generator`` in the port, so the
test gives the port the JAX script's weights (``convert.nn_dynamics_from_jax``)
and compares one step at ``--hidden 16 16``. gen_expert_data writes the same
``.npz`` for each of its four envs: ``x_init`` equal, the rest by the chaos
rule. il_nn_dynamics (``--hidden 16 16``) resumed from a checkpoint equals
its uninterrupted run bit for bit. Every example's ``--help`` works, and
``main`` raises without a card unless given ``--cpu``.

What parts at this size (the JAX package's XLA loop against the port's
fused solve, ROADMAP §3, limits that stay), held to the chaos rule:

- il_acrobot: step 0's loss 6e-4 apart (an MSE of controls 1e-4 apart on
  converged experts);
- gen_expert_data: each env's controls part on converged scenarios at
  objectives 2e-7 apart (up to 1.3e-2 for the cartpole, 3.7e-3 for the
  vehicle).

il_quadrotor and il_nn_dynamics's one step part nowhere: the strict
tolerances hold them.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_examples import (  # noqa: E402
    CHAOS_ATOL,
    CHAOS_RTOL,
    CHAOS_SHARE,
    SIZE,
    STEPS,
    compare_runs,
    distance_room,
    finish_jax,
    help_and_no_card,
    port_main,
    port_steps_kept,
    read_csv,
    resume_matches,
    start_jax,
    steps_params,
)

RUN = SIZE + STEPS
NN = SIZE + ["--hidden", "16", "16", "--steps", "1", "--ckpt-every", "0"]
GEN_ENVS = ("pendulum", "cartpole", "acrobot", "vehicle")
# name: (script, flags, what parts at this size)
CASES = {
    "il_quadrotor": ("il_quadrotor", RUN + ["--ckpt-every", "0"], None),
    "il_acrobot": ("il_acrobot", RUN + ["--ckpt-every", "0"], "step 0's loss 6e-4 apart"),
    "il_nn_dynamics": ("il_nn_dynamics", NN, None),
    **{f"gen_{env}": ("gen_expert_data", ["--cpu", "--env", env, "--batch", "16", "--horizon", "10", "--lqr-iter",
                                          "5"], None) for env in GEN_ENVS},
}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Every case's JAX script, all started at once: name -> (process, its
    out path, its params file)."""
    root = tmp_path_factory.mktemp("jax_examples_zoo")
    runs = {}
    for name, (script, argv, _) in CASES.items():
        out = root / (f"{name}.npz" if script == "gen_expert_data" else name)
        runs[name] = (start_jax(script, argv + ["--out", str(out)], str(root / f"{name}_params.npz")), out,
                      root / f"{name}_params.npz")
    yield runs
    for proc, _, _ in runs.values():
        if proc.poll() is None:
            proc.kill()


@pytest.mark.parametrize("name", ["il_quadrotor", "il_acrobot"])
def test_example_matches_jax(name, jax_runs, tmp_path):
    script, argv, parts = CASES[name]
    _, port_params = port_main(script, argv + ["--out", str(tmp_path)])
    proc, out, params_file = jax_runs[name]
    finish_jax(proc)
    derived = {"param_dist": lambda leaves: distance_room(np.exp(leaves[0]))} if name == "il_acrobot" else {}
    compare_runs(read_csv(str(tmp_path / "train.csv")), read_csv(str(out / "train.csv")), port_params,
                 steps_params(str(params_file)), parts=parts, derived=derived)


def test_il_nn_dynamics_step_matches_jax(jax_runs, tmp_path):
    """One step of the 3-16-16-3 MLP from the JAX script's own first weights
    (``NNDynamics.init`` on ``jax.random.PRNGKey(seed)``)."""
    import jax
    import jax.numpy as jnp
    import torch

    from diffmpc_tpu.models import NNDynamics
    from diffmpc_tpu_torch.convert import nn_dynamics_from_jax
    from diffmpc_tpu_torch.examples import il_nn_dynamics as ex

    args = ex.parse_args(NN + ["--out", str(tmp_path)])
    nn0 = NNDynamics.init(jax.random.PRNGKey(args.seed), 3, 1, hidden=tuple(args.hidden), activation="tanh",
                          residual=True, dtype=jnp.float32)
    port_nn = nn_dynamics_from_jax(nn0, device="cpu")
    device = torch.device("cpu")
    b = ex.build(args, device)
    b["params0"] = {"w": port_nn.weights, "b": port_nn.biases}
    with port_steps_kept() as port_params:
        ex.run(args, b, device)
    proc, out, params_file = jax_runs["il_nn_dynamics"]
    finish_jax(proc)
    compare_runs(read_csv(str(tmp_path / "train.csv")), read_csv(str(out / "train.csv")), port_params,
                 steps_params(str(params_file)))


@pytest.mark.parametrize("env", GEN_ENVS)
def test_gen_expert_data_matches_jax(env, jax_runs, tmp_path):
    """``x_init`` bit-equal; ``objs`` within the chaos rule's objective
    tolerance on at least its share of the scenarios, and on those the
    controls and states within its bound for a tie (5e-2): the ``.npz``
    carries no line-search step to tell a tie from another scenario."""
    from diffmpc_tpu_torch.examples import gen_expert_data

    script, argv, _ = CASES[f"gen_{env}"]
    port = gen_expert_data.main(argv + ["--out", str(tmp_path / "port.npz")])
    proc, out, _ = jax_runs[f"gen_{env}"]
    finish_jax(proc)
    got, want = np.load(str(tmp_path / "port.npz")), np.load(str(out))
    assert sorted(got.files) == sorted(want.files) == ["env", "objs", "us", "x_init", "xs"]
    assert str(got["env"]) == str(want["env"]) == env
    assert np.array_equal(got["x_init"], want["x_init"]) and got["x_init"].dtype == want["x_init"].dtype
    for k in ("xs", "us", "objs"):
        assert got[k].shape == want[k].shape and np.array_equal(got[k], port[k])
    held = np.abs(got["objs"] - want["objs"]) <= CHAOS_ATOL + CHAOS_RTOL * np.abs(want["objs"])
    assert held.mean() >= CHAOS_SHARE, (got["objs"], want["objs"])
    for k in ("us", "xs"):
        np.testing.assert_allclose(got[k][:, held], want[k][:, held], atol=5e-2, rtol=0, err_msg=k)


def test_il_nn_dynamics_resume_is_bit_equal(tmp_path):
    resume_matches("il_nn_dynamics", SIZE + ["--hidden", "16", "16"], str(tmp_path))


@pytest.mark.parametrize("module", ["il_quadrotor", "il_acrobot", "il_nn_dynamics", "gen_expert_data"])
def test_help_and_no_card(module, capsys):
    help_and_no_card(module, capsys)
