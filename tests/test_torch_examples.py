"""The port's training examples against the JAX scripts, on the CPU.

il_pendulum, il_cartpole, il_vehicle and sysid_domain_rand (``--replicas
2``, without and with ``--goal-rand 0.3``) run with the same flags in both
packages (``tests/torch_examples.py``: each JAX script in a subprocess of
its own, the port's ``main`` in process) at ``--batch 16 --horizon 10
--lqr-iter 5 --steps 3``, a size with a live gradient; their ``train.csv``
files and every step's params are compared by
``torch_examples.compare_runs``. il_pendulum resumed from a checkpoint
equals its uninterrupted run bit for bit. Every example's ``--help``
works, and ``main`` raises without a card unless given ``--cpu``.

What parts at this size, and why it is held to the chaos rule: every size
solves on the JAX package's XLA loop against the port's fused solve (ROADMAP
§3, limits that stay).

- il_pendulum: one scenario of sixteen, converged on both sides, ends its
  expert's and its learner's solves 1e-2 apart in its controls at the same
  objective (4e-7 apart): a tie of the chaos rule, which moves the loss by
  2e-3 of itself.
- il_cartpole and il_vehicle: the expert's controls part by up to 1.3e-2
  and 3.7e-3 on converged scenarios at objectives 2e-7 apart; the loss, an
  MSE of controls, follows.
- sysid_domain_rand: a scenario's gradient row, 1e-4 in size, differs in the
  sign of one entry (its replica's controls 3e-5 apart). Adam's first step
  is ``lr * sign(g)``, so that scenario's params part by 2 lr after step 0;
  the aggregates after step 0 mix it in, and the rule holds the params row
  by row on 90% of the scenarios.
- sysid_domain_rand with ``--goal-rand``: step 0's gradient norm 2.6e-4
  apart.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_examples import (  # noqa: E402
    CHAOS_ATOL,
    CHAOS_RTOL,
    SIZE,
    STEPS,
    compare_runs,
    distance_room,
    finish_jax,
    help_and_no_card,
    port_main,
    read_csv,
    resume_matches,
    start_jax,
    steps_params,
)

RUN = SIZE + STEPS
# name: (script, flags, what parts at this size)
CASES = {
    "il_pendulum": ("il_pendulum", RUN + ["--ckpt-every", "0"], "a converged scenario's tie"),
    "il_cartpole": ("il_cartpole", RUN + ["--ckpt-every", "0"], "converged experts' controls 1.3e-2 apart"),
    "il_vehicle": ("il_vehicle", RUN + ["--ckpt-every", "0"], "converged experts' controls 3.7e-3 apart"),
    "sysid": ("sysid_domain_rand", RUN + ["--replicas", "2"], "a gradient row's sign under Adam's first step"),
    "sysid_goal": ("sysid_domain_rand", RUN + ["--replicas", "2", "--goal-rand", "0.3"],
                   "step 0's gradient norm 2.6e-4 apart"),
}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Every case's JAX script, all started at once: name -> (process, its
    out directory, its params file)."""
    root = tmp_path_factory.mktemp("jax_examples")
    runs = {}
    for name, (script, argv, _) in CASES.items():
        out = root / name
        runs[name] = (start_jax(script, argv + ["--out", str(out)], str(root / f"{name}.npz")), out,
                      root / f"{name}.npz")
    yield runs
    for proc, _, _ in runs.values():
        if proc.poll() is None:
            proc.kill()


def _sysid_rooms(argv):
    """sysid_domain_rand's param_err moves by at most the mean of the rule's
    per-entry tolerance over the true params."""
    import torch

    from diffmpc_tpu_torch.examples import sysid_domain_rand as ex

    true = ex.build(ex.parse_args(argv), torch.device("cpu"))["true_params"].numpy()
    return {"param_err": lambda leaves: float(np.mean((CHAOS_ATOL + CHAOS_RTOL * np.abs(leaves[0])) / true))}


@pytest.mark.parametrize("name", list(CASES))
def test_example_matches_jax(name, jax_runs, tmp_path):
    script, argv, parts = CASES[name]
    _, port_params = port_main(script, argv + ["--out", str(tmp_path)])
    proc, out, params_file = jax_runs[name]
    finish_jax(proc)
    port, jax = read_csv(str(tmp_path / "train.csv")), read_csv(str(out / "train.csv"))
    derived, kw = {}, {}
    if name == "il_vehicle":
        derived = {"param_dist": lambda leaves: distance_room(np.exp(leaves[0]))}
    elif name.startswith("sysid"):
        derived, kw = _sysid_rooms(argv), dict(batched=True, aggregates_after_step0=name != "sysid")
    compare_runs(port, jax, port_params, steps_params(str(params_file)), parts=parts, derived=derived, **kw)


def test_il_pendulum_resume_is_bit_equal(tmp_path):
    resume_matches("il_pendulum", SIZE, str(tmp_path))


@pytest.mark.parametrize("module", ["il_pendulum", "il_cartpole", "il_vehicle", "sysid_domain_rand"])
def test_help_and_no_card(module, capsys):
    help_and_no_card(module, capsys)
