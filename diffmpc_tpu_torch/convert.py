"""Carry the JAX package's state over to the port, through numpy arrays.

The functions take the JAX package's objects (``PendulumDx`` and the other
envs of its zoo, ``NNDynamics``, ``AffineDynamics``,
``CtrlPassthroughDynamics``, ``QuadCost``, ``LinDx``, ``MPCConfig``,
``RecedingState``, and a training run's params with its optax Adam state)
and read only their fields, so this module imports neither
JAX nor the JAX package: ``np.asarray`` copies a JAX array to the host.
Both packages then compute the same problem.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.dynamics import AffineDynamics, CtrlPassthroughDynamics, NNDynamics
from .models.envs import AcrobotDx, CartpoleDx, PendulumDx, QuadrotorDx, VehicleDx
from .parallel.training import TrainState, init_train_state
from .receding import RecedingState
from .types import GradMethods, LinDx, MPCConfig, QuadCost
from .utils.tree import tree_leaves, tree_map


def to_tensor(a, dtype=None, device=None) -> torch.Tensor:
    """A JAX (or numpy) array as a tensor with the same values."""
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def pendulum_from_jax(dx, dtype=None, device="cuda") -> PendulumDx:
    """The port's ``PendulumDx`` with the JAX model's params and constants;
    shared ``(3,)`` and per-scenario ``(B, 3)`` params alike. On the card
    unless ``device`` says otherwise."""
    return PendulumDx(
        params=to_tensor(dx.params, dtype, device),
        max_torque=float(dx.max_torque),
        max_speed=float(dx.max_speed),
        dt=float(dx.dt),
        clamp_ctrl=bool(dx.clamp_ctrl),
        n_state=int(dx.n_state),
        n_ctrl=int(dx.n_ctrl),
    )


def _env_from_jax(cls, dx, dtype, device):
    """The port's ``cls`` with the JAX env's params (shared ``(P,)`` or
    per-scenario ``(B, P)``) and every other field (``dt``, the clamps and
    limits, the shape), each as a Python scalar."""
    statics = {f.name: type(f.default)(getattr(dx, f.name)) for f in dataclasses.fields(cls) if f.name != "params"}
    return cls(params=to_tensor(dx.params, dtype, device), **statics)


def cartpole_from_jax(dx, dtype=None, device="cuda") -> CartpoleDx:
    """The port's ``CartpoleDx`` with the JAX model's params and constants,
    on the card unless ``device`` says otherwise."""
    return _env_from_jax(CartpoleDx, dx, dtype, device)


def vehicle_from_jax(dx, dtype=None, device="cuda") -> VehicleDx:
    """The port's ``VehicleDx`` with the JAX model's params and constants
    (``v_ref`` among them), on the card unless ``device`` says otherwise."""
    return _env_from_jax(VehicleDx, dx, dtype, device)


def quadrotor_from_jax(dx, dtype=None, device="cuda") -> QuadrotorDx:
    """The port's ``QuadrotorDx`` with the JAX model's params and constants,
    on the card unless ``device`` says otherwise."""
    return _env_from_jax(QuadrotorDx, dx, dtype, device)


def acrobot_from_jax(dx, dtype=None, device="cuda") -> AcrobotDx:
    """The port's ``AcrobotDx`` with the JAX model's params and constants,
    on the card unless ``device`` says otherwise."""
    return _env_from_jax(AcrobotDx, dx, dtype, device)


def nn_dynamics_from_jax(dx, dtype=None, device="cuda") -> NNDynamics:
    """The port's ``NNDynamics`` with the JAX model's weights, biases,
    activation and residual flag, on the card unless ``device`` says
    otherwise."""
    return NNDynamics(
        tuple(to_tensor(w, dtype, device) for w in dx.weights),
        tuple(to_tensor(b, dtype, device) for b in dx.biases),
        activation=dx.activation,
        residual=bool(dx.residual),
    )


def affine_dynamics_from_jax(dx, dtype=None, device="cuda") -> AffineDynamics:
    """The port's ``AffineDynamics`` with the JAX one's ``A``, ``B`` and
    ``c`` (None stays None), on the card unless ``device`` says otherwise."""
    c = None if dx.c is None else to_tensor(dx.c, dtype, device)
    return AffineDynamics(to_tensor(dx.A, dtype, device), to_tensor(dx.B, dtype, device), c)


def ctrl_passthrough_from_jax(dx, dtype=None, device="cuda") -> CtrlPassthroughDynamics:
    """The port's ``CtrlPassthroughDynamics`` around the JAX wrapper's inner
    model, converted by the converter of its class (:data:`MODEL_FROM_JAX`),
    on the card unless ``device`` says otherwise."""
    return CtrlPassthroughDynamics(inner=model_from_jax(dx.inner, dtype, device), n_ctrl=int(dx.n_ctrl))


def quad_cost_from_jax(cost, dtype=None, device="cuda") -> QuadCost:
    """The port's ``QuadCost`` with the JAX one's ``C`` and ``c``, on the card
    unless ``device`` says otherwise."""
    return QuadCost(to_tensor(cost.C, dtype, device), to_tensor(cost.c, dtype, device))


def lin_dx_from_jax(dx, dtype=None, device="cuda") -> LinDx:
    """The port's ``LinDx`` with the JAX one's ``F`` and ``f`` (None stays
    None), on the card unless ``device`` says otherwise."""
    f = None if dx.f is None else to_tensor(dx.f, dtype, device)
    return LinDx(to_tensor(dx.F, dtype, device), f)


def mpc_config_from_jax(config) -> MPCConfig:
    """The port's ``MPCConfig`` with the same knobs. ``use_pallas`` becomes
    ``use_cuda``: the TPU kernel (``True``) maps to the CUDA kernel, the
    non-kernel path (``False``) to the plain version, and auto (``None``)
    or the kernel in interpret mode, which runs it on the CPU, to ``None``:
    the kernel for CUDA tensors and the plain version for CPU tensors.
    ``hoist_lin``, ``pnqp_enum`` and ``value_update_exact_reg`` keep their
    defaults: the JAX package holds them outside its config, as the env
    knobs ``DIFFMPC_HOIST_LIN`` and ``DIFFMPC_PNQP_ENUM`` and the module
    global ``VALUE_UPDATE_EXACT_REG`` (``ops/pallas/riccati.py``)."""
    kw = {}
    for f in dataclasses.fields(MPCConfig):
        if f.name in ("use_cuda", "hoist_lin", "pnqp_enum", "value_update_exact_reg"):
            continue
        value = getattr(config, f.name)
        if f.name == "grad_method":
            value = GradMethods(value.value)
        kw[f.name] = value
    use_pallas = config.use_pallas
    kw["use_cuda"] = None if use_pallas is None or (use_pallas and config.pallas_interpret) else bool(use_pallas)
    return MPCConfig(**kw)


def receding_state_from_jax(state, dtype=None, device="cuda") -> RecedingState:
    """The port's ``RecedingState`` with the JAX one's ``x``, ``u_warm`` and
    ``prev_u``, on the card unless ``device`` says otherwise."""
    return RecedingState(*(to_tensor(a, dtype, device) for a in (state.x, state.u_warm, state.prev_u)))


# the JAX package's model classes, by name, and their converters
MODEL_FROM_JAX = {
    "PendulumDx": pendulum_from_jax,
    "CartpoleDx": cartpole_from_jax,
    "VehicleDx": vehicle_from_jax,
    "QuadrotorDx": quadrotor_from_jax,
    "AcrobotDx": acrobot_from_jax,
    "NNDynamics": nn_dynamics_from_jax,
    "AffineDynamics": affine_dynamics_from_jax,
    "CtrlPassthroughDynamics": ctrl_passthrough_from_jax,
}


def model_from_jax(dx, dtype=None, device="cuda"):
    """Any JAX model of :data:`MODEL_FROM_JAX`, by its class's name."""
    name = type(dx).__name__
    if name not in MODEL_FROM_JAX:
        raise TypeError(f"no converter for the JAX model {name}: one of {sorted(MODEL_FROM_JAX)}")
    return MODEL_FROM_JAX[name](dx, dtype, device)


def train_state_from_jax(params, opt_state, optimizer, device="cuda") -> TrainState:
    """A JAX training run's state, continued in the port: ``params`` (a
    JAX array or a pytree of them, as ``TrainState.params``) and
    ``opt_state``, the ``optax.adam`` state over them (the chain's
    ``ScaleByAdamState``, found by its fields ``count``, ``mu``, ``nu``),
    become :func:`~.parallel.training.init_train_state`'s state with the
    optimizer ``optimizer`` (a factory over the leaves, such as
    ``functools.partial(torch.optim.Adam, lr=...)``) holding the moments:
    ``mu`` as ``exp_avg``, ``nu`` as ``exp_avg_sq`` and ``count`` as
    ``step``. The two optimizers then take the same next step (the same
    rule: bias-corrected moments, ``eps`` added to the corrected
    second-moment root). On the card unless ``device`` says otherwise."""
    found = [opt_state, *opt_state] if isinstance(opt_state, (list, tuple)) else [opt_state]
    adam = [s for s in found if all(hasattr(s, f) for f in ("count", "mu", "nu"))]
    if len(adam) != 1:
        raise TypeError(f"train_state_from_jax: no one Adam state (count, mu, nu) in {type(opt_state).__name__}")
    (adam,) = adam
    state = init_train_state(tree_map(lambda a: to_tensor(a, device=device), params), optimizer)
    leaves = tree_leaves(state.params)
    mus, nus = tree_leaves(adam.mu), tree_leaves(adam.nu)
    if len(mus) != len(leaves) or len(nus) != len(leaves):
        raise ValueError(f"train_state_from_jax: {len(leaves)} params against {len(mus)} / {len(nus)} moments")
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    moments = {i: {"step": step.clone(), "exp_avg": to_tensor(mu, leaf.dtype, leaf.device),
                   "exp_avg_sq": to_tensor(nu, leaf.dtype, leaf.device)}
               for i, (leaf, mu, nu) in enumerate(zip(leaves, mus, nus))}
    opt = state.opt_state
    opt.load_state_dict({"state": moments, "param_groups": opt.state_dict()["param_groups"]})
    return state
