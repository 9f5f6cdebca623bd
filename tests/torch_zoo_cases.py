"""The dynamics zoo's problems, shared by the port's zoo tests: each env's
float64 golden recipe of tests/test_parity_golden.py:157-215 (its starts,
horizon and box, drawn with numpy from the golden's seed) and the port's
model of the env."""

import numpy as np

ZOO = ("cartpole", "vehicle", "quadrotor", "acrobot")
GOLDENS = {"cartpole": "cartpole_T20B16_f64", "vehicle": "vehicle_T20B16_f64",
           "quadrotor": "quadrotor_T20B16_f64", "acrobot": "acrobot_T40B16_f64"}


def golden_case(name: str, B: int = 16):
    """``(x_init (B, n), n, m, T, (lo, hi))`` of the env's golden: B=16 is
    the golden's own draw; a larger B draws more from the same stream."""
    if name == "cartpole":
        rng = np.random.default_rng(779)
        th = rng.uniform(-0.3, 0.3, B)
        x = np.stack([rng.uniform(-0.5, 0.5, B), rng.uniform(-0.5, 0.5, B), np.cos(th), np.sin(th),
                      rng.uniform(-0.5, 0.5, B)], -1)
        return x, 5, 1, 20, (-10.0, 10.0)
    if name == "quadrotor":
        rng = np.random.default_rng(778)
        x = np.stack([rng.uniform(-0.5, 0.5, B), rng.uniform(-0.5, 0.5, B)]
                     + [rng.uniform(-0.3, 0.3, B) for _ in range(4)], -1)
        return x, 6, 2, 20, (0.0, 5.0)
    if name == "acrobot":
        rng = np.random.default_rng(881)
        th1 = rng.uniform(-0.05, 0.05, B)
        th2 = rng.uniform(-0.05, 0.05, B)
        x = np.stack([np.cos(th1), np.sin(th1), np.cos(th2), np.sin(th2), rng.uniform(-0.05, 0.05, B),
                      rng.uniform(-0.05, 0.05, B)], -1)
        return x, 6, 1, 40, (-4.0, 4.0)
    rng = np.random.default_rng(882)
    x = np.stack([np.zeros(B), rng.uniform(-1.0, 1.0, B), rng.uniform(-0.3, 0.3, B), rng.uniform(3.0, 7.0, B)], -1)
    # the asymmetric mixed box: accel [-6, 3], steer [-0.5, 0.5]
    return x, 4, 2, 20, (np.array([-6.0, -0.5]), np.array([3.0, 0.5]))


def port_model(name: str, dtype, params=None):
    """The port's env ``name`` on the CPU: its default params, or ``params``
    (shared ``(P,)`` or per-scenario ``(B, P)``)."""
    import torch

    from diffmpc_tpu_torch import models

    dx = getattr(models, f"{name.capitalize()}Dx").default(dtype, device="cpu")
    return dx if params is None else dx.replace(params=torch.as_tensor(params, dtype=dtype))


def kernel_problem(name: str, B: int, T: int, dtype, per_scenario: bool = False, seed: int = 0):
    """The fused solve's inputs of the env's golden recipe at ``B``
    scenarios over ``T`` steps: ``(x_init, C, c, dyn, u_lower, u_upper)``,
    the goal cost of ``get_true_obj`` and the golden's box; with
    ``per_scenario`` each scenario's params 0.8-1.2 of the true ones."""
    import torch

    x, n, m, _, (lo, hi) = golden_case(name, B)
    dx = port_model(name, dtype)
    if per_scenario:
        spread = np.random.default_rng(seed).uniform(0.8, 1.2, (B, dx.params.shape[-1]))
        dx = dx.replace(params=dx.params * torch.tensor(spread, dtype=dtype))
    q, p = port_model(name, dtype).get_true_obj()
    nm = n + m
    box = [torch.as_tensor(b, dtype=dtype).expand(T, B, m).contiguous() for b in (lo, hi)]
    return (torch.tensor(x, dtype=dtype), torch.diag(q).expand(T, B, nm, nm), p.expand(T, B, nm), dx, *box)


def one_robot_problem(env: str, device):
    """The render example's one-robot solve (diffmpc_tpu_torch/examples/
    render_trajectory.py: B=1, T=15, its start, cost and box, the vehicle's
    per control and the quadrotor's [0, max_thrust]) on ``device``, as the
    fused solve's inputs ``(x_init, C, c, dyn, u_lower, u_upper)``, the
    bounds broadcast to (T, 1, m)."""
    import torch

    from diffmpc_tpu_torch.examples import render_trajectory as ex

    s = ex.build(ex.parse_args(["--env", env]), device)
    T, nm, m = s["config"].T, s["config"].n_state + s["config"].n_ctrl, s["config"].n_ctrl
    box = [torch.as_tensor(b, dtype=torch.float32, device=device).expand(T, 1, m) for b in (s["lo"], s["hi"])]
    return (s["x0"], s["cost"].C.expand(T, 1, nm, nm), s["cost"].c.expand(T, 1, nm), s["dx"], *box)
