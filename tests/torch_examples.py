"""Running the JAX examples beside the port's, for the port's example tests.

Each JAX script (``examples/<name>.py``) runs unchanged in a subprocess of
its own, started early so that the JAX compilations overlap the port's runs:
a small runner puts ``examples/`` on ``sys.path``, wraps
``diffmpc_tpu.parallel.make_dp_train_step`` so that every step's params
are kept as numpy arrays, runs the script by ``runpy`` with ``sys.argv``
set, and saves those params beside the script's ``train.csv``. The port's
example runs in process through ``main``, its ``make_dp_train_step``
wrapped the same way.

The two packages take different paths on the CPU: the JAX package its
XLA loop, the port its fused solve (ROADMAP §3, limits that stay: with
``eps > 0`` they part on a scenario frozen early). So a size whose solves
part by the chaos rule of ``tests/torch_parity.py`` is held to that rule's
tolerances (:func:`compare_runs`), and the test names what parts.
"""

from __future__ import annotations

import contextlib
import csv
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
# every example test's size: a live gradient (at --batch 8 --horizon 6
# --lqr-iter 3 the pendulum's controls saturate the box and every grad_norm
# is 0)
SIZE = ["--cpu", "--batch", "16", "--horizon", "10", "--lqr-iter", "5"]
STEPS = ["--steps", "3"]
# the chaos rule's tolerances (tests/torch_parity.py::assert_chaos): the
# objectives of the scenarios it holds, rtol and atol; its share of such
# scenarios
CHAOS_RTOL = CHAOS_ATOL = 1e-3
CHAOS_SHARE = 0.9

RUNNER = r"""
import runpy, sys
sys.path[:0] = [EXAMPLES, REPO]
import numpy as np
import jax
import diffmpc_tpu.parallel as parallel

script, out, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
made = parallel.make_dp_train_step
kept = []


def make_dp_train_step(*args, **kwargs):
    step = made(*args, **kwargs)

    def kept_step(state, *rest):
        state, stats = step(state, *rest)
        kept.append([np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(state.params)])
        return state, stats

    return kept_step


parallel.make_dp_train_step = make_dp_train_step
sys.argv = [script] + argv
runpy.run_path(script, run_name="__main__")
np.savez(out, **{f"s{i}_l{j}": leaf for i, leaves in enumerate(kept) for j, leaf in enumerate(leaves)})
"""


def start_jax(script: str, argv: list, params_out: str) -> subprocess.Popen:
    """Start ``examples/<script>.py`` with ``argv`` in a subprocess (see the
    module docstring); its per-step params go to ``params_out`` (.npz)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.Popen(
        [sys.executable, "-c", RUNNER.replace("EXAMPLES", repr(EXAMPLES)).replace("REPO", repr(REPO)),
         f"{script}.py", params_out, *argv],
        cwd=EXAMPLES, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_jax(proc: subprocess.Popen, timeout: float = 600) -> str:
    """Wait for a :func:`start_jax` run; returns its stdout, raises on a
    failure."""
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return out


def steps_params(path: str) -> list:
    """The per-step params a run kept: a list over steps of lists of leaves."""
    data = np.load(path)
    steps = {}
    for key in data.files:
        i, j = (int(part[1:]) for part in key.split("_"))
        steps.setdefault(i, {})[j] = data[key]
    return [[steps[i][j] for j in sorted(steps[i])] for i in sorted(steps)]


@contextlib.contextmanager
def port_steps_kept():
    """Within the block, the port's examples keep every step's params
    (host numpy leaves); yields the list they fill."""
    from diffmpc_tpu_torch.examples import common
    from diffmpc_tpu_torch.utils.tree import tree_leaves

    made, kept = common.make_dp_train_step, []

    def make_dp_train_step(*args, **kwargs):
        step = made(*args, **kwargs)

        def kept_step(state, *rest):
            state, stats = step(state, *rest)
            kept.append([leaf.detach().cpu().numpy().copy() for leaf in tree_leaves(state.params)])
            return state, stats

        return kept_step

    common.make_dp_train_step = make_dp_train_step
    try:
        yield kept
    finally:
        common.make_dp_train_step = made


def read_csv(path: str) -> dict:
    """``train.csv`` as columns of floats, ``dt`` left out."""
    with open(path) as fh:
        rows = list(csv.DictReader(fh))
    return {k: np.array([float(r[k]) for r in rows]) for k in rows[0] if k != "dt"}


def close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def distance_room(learned) -> float:
    """What the chaos rule lets ``|learned - true|`` move: the norm of its
    per-entry tolerance at the learned params."""
    return float(np.linalg.norm(CHAOS_ATOL + CHAOS_RTOL * np.abs(learned)))


def compare_runs(port: dict, jax: dict, port_params: list, jax_params: list, parts: str = None,
                 derived: dict = None, batched: bool = False, aggregates_after_step0: bool = True) -> None:
    """Hold the port's run (``train.csv`` columns and per-step params) to the
    JAX script's.

    Both sides: the same steps, ``grad_norm > 0`` at every step (else the
    comparison is vacuous), ``converged_frac`` equal at step 0.

    Where the size does not part (``parts`` None): step 0's loss and
    grad_norm within 1e-4 relative; every later value, the CSV's param
    columns and the learned params at every step within 1e-3 relative.

    Where it parts (``parts`` names how): every value by the chaos rule's
    objective tolerance (rtol and atol 1e-3, ``CHAOS_*``). A ``derived``
    column (a distance of the learned params from the true ones) moves by at
    most what the rule lets the params move: ``derived[column](leaves)``,
    from the JAX side's leaves of the step. Per-scenario params (``batched``, one
    row a scenario) are held row by row on ``CHAOS_SHARE`` of the scenarios;
    where Adam's first step parts a scenario's params (``lr * sign(g)`` of a
    gradient entry near 0), ``aggregates_after_step0`` is False: the
    aggregates of the params it parted (every later step's loss and gradient
    norm, and the param columns, which log the params after each step) are
    not comparable by the rule; step 0's loss, gradient norm and converged
    share are."""
    assert np.array_equal(port["step"], jax["step"]), (port["step"], jax["step"])
    for side, run in (("port", port), ("jax", jax)):
        assert (run["grad_norm"] > 0).all(), (side, run["grad_norm"])
        assert np.isfinite(run["loss"]).all(), (side, run["loss"])
    assert port["converged_frac"][0] == jax["converged_frac"][0], (port["converged_frac"], jax["converged_frac"])
    assert len(port_params) == len(jax_params) == len(port["step"])
    derived = derived or {}
    params_cols = [k for k in jax if k not in ("step", "loss", "grad_norm", "converged_frac")]
    if parts is None:
        for k in ("loss", "grad_norm"):
            close(port[k][:1], jax[k][:1], 1e-4, what=f"step 0 {k}")
            close(port[k][1:], jax[k][1:], 1e-3, what=f"later {k}")
        close(port["converged_frac"], jax["converged_frac"], 1e-3, what="converged_frac")
        for k in params_cols:
            close(port[k], jax[k], 1e-3, what=k)
        for i, (p, j) in enumerate(zip(port_params, jax_params)):
            for a, b in zip(p, j):
                close(a, b, 1e-3, what=f"params after step {i}")
        return
    steps = slice(None) if aggregates_after_step0 else slice(0, 1)
    for k in ("loss", "grad_norm", "converged_frac"):
        close(port[k][steps], jax[k][steps], CHAOS_RTOL, CHAOS_ATOL, what=f"{k} ({parts})")
    for i, (p, j) in enumerate(zip(port_params, jax_params)):
        for a, b in zip(p, j):
            if batched:
                held = np.all(np.abs(a - b) <= CHAOS_ATOL + CHAOS_RTOL * np.abs(b), axis=-1)
                assert held.mean() >= CHAOS_SHARE, (i, held, a, b)
            else:
                close(a, b, CHAOS_RTOL, CHAOS_ATOL, what=f"params after step {i} ({parts})")
    for k in params_cols if aggregates_after_step0 else ():
        if k in derived:
            for i, j in enumerate(jax_params):
                room = derived[k](j)
                assert abs(port[k][i] - jax[k][i]) <= room, (k, i, port[k][i], jax[k][i], room)
        else:
            close(port[k], jax[k], CHAOS_RTOL, CHAOS_ATOL, what=f"{k} ({parts})")


def port_main(module: str, argv: list):
    """Run the port's ``examples/<module>`` through ``main(argv)`` in process,
    keeping every step's params; returns ``(main's result, kept params)``."""
    import importlib

    ex = importlib.import_module(f"diffmpc_tpu_torch.examples.{module}")
    with port_steps_kept() as kept:
        out = ex.main(argv)
    return out, kept


def resume_matches(module: str, argv: list, out_dir) -> None:
    """Four steps in one run against two, then ``--resume`` for two more:
    every ``train.csv`` value (``dt`` aside) and the final params and Adam
    state bit-equal. ``argv`` holds no ``--steps``."""
    import torch

    whole, parts = os.path.join(out_dir, "whole"), os.path.join(out_dir, "parts")
    base = list(argv)
    state = port_main(module, base + ["--steps", "4", "--ckpt-every", "2", "--out", whole])[0]
    port_main(module, base + ["--steps", "2", "--ckpt-every", "2", "--out", parts])
    resumed = port_main(module, base + ["--steps", "4", "--ckpt-every", "2", "--resume", "--out", parts])[0]
    a, b = read_csv(os.path.join(whole, "train.csv")), read_csv(os.path.join(parts, "train.csv"))
    for k in a:
        assert np.array_equal(a[k], b[k]), (k, a[k], b[k])
    from diffmpc_tpu_torch.utils.tree import tree_leaves

    for x, y in zip(tree_leaves(state.params), tree_leaves(resumed.params)):
        assert torch.equal(x, y)
    sa, sb = state.opt_state.state_dict()["state"], resumed.opt_state.state_dict()["state"]
    assert sorted(sa) == sorted(sb)
    for k in sa:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k][name], sb[k][name]), (k, name)
    assert sorted(os.listdir(os.path.join(parts, "ckpt"))) == ["step_2", "step_4"]


def help_and_no_card(module: str, capsys) -> None:
    """``--help`` prints the usage; without ``--cpu`` and without a card,
    ``main`` raises."""
    import importlib

    import pytest
    import torch

    ex = importlib.import_module(f"diffmpc_tpu_torch.examples.{module}")
    with pytest.raises(SystemExit) as e:
        ex.main(["--help"])
    assert e.value.code == 0 and "usage" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            ex.main(["--batch", "2"])
