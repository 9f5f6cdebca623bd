"""The render example of the port (``diffmpc_tpu_torch.examples.render_trajectory``),
the envs' ``get_frame`` and the pendulum's ``angle_from_state``, against the
JAX package on the CPU.

- The example's one-robot episode (B=1, its starts, boxes and config, at
  T=8 and 6 env steps) through the port's ``build`` and ``episode`` in
  float64 against ``diffmpc_tpu.run_receding_horizon`` on the same starts,
  for all five envs: states and controls within 1e-9.
- Each env's ``get_frame`` against the JAX env's on the same state (a
  tensor and a numpy array): every line's data, colour, width, style and
  marker, the cartpole's ``Rectangle`` (corner, width, height) and the axes'
  limits within 1e-12; a model with per-scenario params raises the same
  ``ValueError``.
- ``PendulumDx.angle_from_state`` against the JAX one.
- ``main`` with ``--cpu`` writes ``steps + 1`` PNGs and the GIF (the
  pendulum and the vehicle); without ``--cpu`` and without a card it raises.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402

import diffmpc_tpu as jdm  # noqa: E402
from diffmpc_tpu import models as jax_models  # noqa: E402
from diffmpc_tpu_torch import models  # noqa: E402
from diffmpc_tpu_torch.examples import render_trajectory as ex  # noqa: E402

jax.config.update("jax_enable_x64", True)

ENVS = ex.ENVS
T, STEPS = 8, 6


def _port_case(env: str) -> dict:
    args = ex.parse_args(["--env", env, "--horizon", str(T), "--steps", str(STEPS)])
    return ex.build(args, "cpu", torch.float64)


@functools.partial(jax.jit, static_argnums=0)
def _jax_episode(env: str, x0, lo, hi):
    """The JAX script's episode (examples/render_trajectory.py) at this
    file's T and steps, in float64, from ``x0`` in the box ``[lo, hi]``."""
    dx = getattr(jax_models, f"{env.capitalize()}Dx").default(jnp.float64)
    q, p = dx.get_true_obj()
    config = jdm.MPCConfig(n_state=dx.n_state, n_ctrl=dx.n_ctrl, T=T, lqr_iter=8, eps=1e-5,
                           exit_unconverged=False, detach_unconverged=False)
    return jdm.run_receding_horizon(config, x0, jdm.QuadCost(jnp.diag(q), p), dx, STEPS, u_lower=lo, u_upper=hi)


@pytest.mark.parametrize("env", ENVS)
def test_one_robot_episode_matches_jax(env):
    s = _port_case(env)
    assert s["x0"].shape == (1, s["dx"].n_state) and s["x0"].dtype == torch.float64
    xs, us, objs = ex.episode(s, STEPS)
    box = [jnp.asarray(np.asarray(b.numpy() if torch.is_tensor(b) else b, np.float64)) for b in (s["lo"], s["hi"])]
    jxs, jus, jobjs = _jax_episode(env, jnp.asarray(s["x0"].numpy()), *box)
    assert xs.shape == (STEPS + 1, 1, s["dx"].n_state) and us.shape == (STEPS, 1, s["dx"].n_ctrl)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=0, atol=1e-9)
    np.testing.assert_allclose(us.numpy(), np.asarray(jus), rtol=0, atol=1e-9)
    np.testing.assert_allclose(objs.numpy(), np.asarray(jobjs), rtol=1e-9, atol=1e-9)
    lo, hi = (np.broadcast_to(b, (s["dx"].n_ctrl,)) for b in box)
    assert (us.numpy() >= lo - 1e-12).all() and (us.numpy() <= hi + 1e-12).all()


def test_build_keeps_the_jax_scripts_starts_boxes_and_config():
    want = {"pendulum": ([np.cos(0.7), np.sin(0.7), 0.0], -2.0, 2.0),
            "cartpole": ([0.0, 0.0, np.cos(0.7), np.sin(0.7), 0.0], -10.0, 10.0),
            "quadrotor": ([0.5, 0.5, 0.35, 0.0, 0.0, 0.0], 0.0, 5.0),
            "acrobot": ([np.cos(0.175), np.sin(0.175), np.cos(-0.175), np.sin(-0.175), 0.0, 0.0], -4.0, 4.0),
            "vehicle": ([0.0, 1.0, 0.35, 5.0], [-6.0, -0.5], [3.0, 0.5])}
    for env, (x0, lo, hi) in want.items():
        s = ex.build(ex.parse_args(["--env", env]), "cpu")
        np.testing.assert_array_equal(s["x0"].numpy(), np.asarray([x0], np.float32))
        for got, w in ((s["lo"], lo), (s["hi"], hi)):
            np.testing.assert_array_equal(np.asarray(got.numpy() if torch.is_tensor(got) else got, np.float32),
                                          np.asarray(w, np.float32))
        cfg = s["config"]
        assert (cfg.T, cfg.lqr_iter, cfg.eps, cfg.exit_unconverged, cfg.detach_unconverged) == (15, 8, 1e-5, False,
                                                                                              False)


def _state(env: str, seed: int) -> np.ndarray:
    """A state of ``env`` drawn from ``seed``: positions and speeds in
    [-1, 1], each angle's (cos, sin) of an angle in [-pi, pi]."""
    rng = np.random.default_rng(seed)
    angles = {"pendulum": (0,), "cartpole": (2,), "acrobot": (0, 2)}.get(env, ())
    n = getattr(models, f"{env.capitalize()}Dx").n_state
    x = rng.uniform(-1.0, 1.0, n)
    for i in angles:
        th = rng.uniform(-np.pi, np.pi)
        x[i], x[i + 1] = np.cos(th), np.sin(th)
    return x


def _artists(ax) -> dict:
    return dict(lines=[(ln.get_xydata(), ln.get_color(), ln.get_linewidth(), ln.get_linestyle(), ln.get_marker())
                       for ln in ax.get_lines()],
                rects=[(np.asarray(r.get_xy()), r.get_width(), r.get_height(), r.get_facecolor())
                       for r in ax.patches],
                xlim=ax.get_xlim(), ylim=ax.get_ylim())


def _assert_same_frame(got: dict, want: dict) -> None:
    assert len(got["lines"]) == len(want["lines"]) and len(got["rects"]) == len(want["rects"])
    for (xy, *style), (wxy, *wstyle) in zip(got["lines"], want["lines"]):
        np.testing.assert_allclose(xy, wxy, rtol=0, atol=1e-12)
        assert style == wstyle
    for (xy, w, h, fc), (wxy, ww, wh, wfc) in zip(got["rects"], want["rects"]):
        np.testing.assert_allclose([*xy, w, h], [*wxy, ww, wh], rtol=0, atol=1e-12)
        assert fc == wfc
    np.testing.assert_allclose(got["xlim"], want["xlim"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["ylim"], want["ylim"], rtol=0, atol=1e-12)


@pytest.mark.parametrize("env", ENVS)
def test_get_frame_draws_what_jax_draws(env):
    name = f"{env.capitalize()}Dx"
    port = getattr(models, name).default(torch.float64, device="cpu")
    jax_dx = getattr(jax_models, name).default(jnp.float64)
    try:
        for seed in (0, 1):
            x = _state(env, 190 + seed)
            frames = []
            for dx, state in ((jax_dx, jnp.asarray(x)), (port, torch.tensor(x)), (port, x)):
                _, ax = plt.subplots()
                assert dx.get_frame(state, ax=ax) is ax
                frames.append(_artists(ax))
            for got in frames[1:]:
                _assert_same_frame(got, frames[0])
        # without ax each draws a figure of its own, of the same size
        made = [dx.get_frame(state).figure.get_size_inches()
                for dx, state in ((jax_dx, jnp.asarray(x)), (port, torch.tensor(x)))]
        np.testing.assert_array_equal(made[0], made[1])
        # a model of per-scenario params renders no frame, in the same words
        errors = []
        for dx, params in ((jax_dx, jnp.stack([jax_dx.params] * 2)), (port, torch.stack([port.params] * 2))):
            with pytest.raises(ValueError) as e:
                dx.replace(params=params).get_frame(x)
            errors.append(str(e.value))
        assert errors[0] == errors[1]
    finally:
        plt.close("all")


def test_angle_from_state_matches_jax():
    rng = np.random.default_rng(191)
    th = rng.uniform(-np.pi, np.pi, (4, 5))
    x = np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, th.shape)], -1) * rng.uniform(0.5, 2.0, th.shape)[..., None]
    got = models.PendulumDx.default(torch.float64, device="cpu").angle_from_state(torch.tensor(x))
    want = jax_models.PendulumDx.default(jnp.float64).angle_from_state(jnp.asarray(x))
    assert got.shape == (4, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-15)


@pytest.mark.parametrize("env", ["pendulum", "vehicle"])
def test_main_writes_the_frames_and_the_gif(env, tmp_path, capsys):
    out, gif = tmp_path / "frames", tmp_path / "a.gif"
    paths = ex.main(["--cpu", "--env", env, "--steps", "3", "--horizon", "6", "--out", str(out), "--gif", str(gif)])
    assert sorted(os.listdir(out)) == [f"frame_{t:04d}.png" for t in range(4)] and len(paths) == 4
    assert gif.stat().st_size > 0
    from PIL import Image

    with Image.open(gif) as img:
        assert img.n_frames == 4
    printed = capsys.readouterr().out.splitlines()
    assert printed[-2:] == [f"wrote 4 frames to {out}", f"wrote {gif}"]


def test_main_raises_without_a_card_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        ex.main(["--steps", "1", "--out", str(tmp_path / "frames")])
    assert not (tmp_path / "frames").exists()
