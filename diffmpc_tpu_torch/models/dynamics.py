"""Dynamics model zoo (counterpart of :mod:`diffmpc_tpu.models.dynamics`).

Models are frozen dataclasses holding tensors. ``forward(x, u)`` broadcasts
over leading batch dims and ``grad_input(x, u)`` returns the state/control
Jacobians ``(A, B)`` of ``GradMethods.ANALYTIC`` linearization; both are
differentiable in the model's own tensors, which is how a gradient reaches
them through the KKT backward. Models that ride the fused iLQR solve also
provide ``entries_step(params, x_entries, u_entries)``: one step on lists of
per-entry ``(B,)`` tensors, which the solve linearizes by forward-mode
differentiation, and which the CUDA kernels mirror line for line in C++
(``csrc/pendulum.cuh``, ``csrc/nn_mlp.cuh``).

- :class:`AffineDynamics`: ``x' = A x + B u + c``, forward only (no kernel
  step): the non-fused loop's ladder rolls it out.
- :class:`NNDynamics`: an MLP on ``[x; u]``. Small ones pass the fusable
  gate and run inside the kernels; larger ones take the non-fused loop.
- :class:`CtrlPassthroughDynamics`: a model whose state carries a copy of
  the last control, the slew-rate penalty's augmented problem. Its kernel
  step is the inner model's, composed (``csrc/passthrough.cuh``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.func import jacfwd, vmap

from ..utils.batch import bmv


class Dynamics:
    """Protocol: ``forward(x, u) -> x_next`` and ``grad_input(x, u) -> (A, B)``
    with ``A (..., n, n)``, ``B (..., n, m)``; for fused solves also
    ``entries_step`` + :meth:`kernel_params`.

    Per-scenario (domain-randomized) parameters: a model whose ``params`` is
    a single tensor may give it a leading batch axis, ``(B, P)`` instead of
    ``(P,)``, so that every scenario of the solve has its own physics.
    """

    def forward(self, x, u):  # pragma: no cover - interface
        raise NotImplementedError

    @property
    def param_batch_shape(self) -> tuple:
        """Leading batch shape of per-scenario ``params`` (``()`` when the
        parameters are shared, or when the model has no ``params``)."""
        p = getattr(self, "params", None)
        if isinstance(p, torch.Tensor) and p.ndim >= 2:
            return tuple(p.shape[:-1])
        return ()

    @property
    def kernel_fusable(self) -> bool:
        """Whether ``entries_step`` may run inside the fused solve."""
        return True

    def kernel_params(self) -> torch.Tensor:
        """Flat parameter vector ``(P,)`` (or per-scenario ``(B, P)``) read
        by ``entries_step`` inside the fused solve."""
        return self.params

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def tensors(self) -> list:
        """Every tensor the model holds (its fields or attributes, tuples
        included): what a gradient may reach."""
        if dataclasses.is_dataclass(self):
            values = [getattr(self, f.name) for f in dataclasses.fields(self)]
        else:
            values = list(vars(self).values())
        out = []
        for v in values:
            for t in v if isinstance(v, (tuple, list)) else (v,):
                if isinstance(t, torch.Tensor):
                    out.append(t)
        return out

    def to(self, dtype=None, device=None):
        """The model with every tensor cast to ``dtype`` and moved to
        ``device`` (None keeps each)."""

        def cast(v):
            if isinstance(v, torch.Tensor):
                return v.to(dtype=dtype or v.dtype, device=device or v.device)
            if isinstance(v, tuple):
                return tuple(cast(t) for t in v)
            return v

        return self.replace(**{f.name: cast(getattr(self, f.name)) for f in dataclasses.fields(self)})

    def grad_input(self, x, u):
        """Default: exact Jacobians by forward-mode autodiff of ``forward``
        (AUTO_DIFF equals ANALYTIC here; models override with closed forms).
        Per-scenario params map the Jacobian jointly over ``(params, x, u)``
        on the scenario axis: closing over ``(B, P)`` params inside a
        per-sample map would broadcast the wrong shapes. The Jacobians come
        back in ``forward``'s dtype, as the JAX package's do: under
        ``jacfwd`` a Python float in a sum can promote the tangents of a
        float32 step to float64."""
        dtype = torch.promote_types(x.dtype, u.dtype)
        p = getattr(self, "params", None)
        if isinstance(p, torch.Tensor):
            dtype = torch.promote_types(dtype, p.dtype)
        if not self.param_batch_shape:
            return tuple(J.to(dtype) for J in autodiff_grad_input(self.forward, x, u))
        if x.ndim not in (2, 3):
            raise ValueError(f"per-scenario params need x of shape (B, n) or (T, B, n); got {tuple(x.shape)}")

        def one(p, xx, uu):
            return jacfwd(self.replace(params=p).forward, argnums=(0, 1))(xx, uu)

        f = vmap(one)  # over the scenario axis
        if x.ndim == 3:
            f = vmap(f, in_dims=(None, 0, 0))  # over time
        return tuple(J.to(dtype) for J in f(self.params, x, u))

    def __call__(self, x, u):
        return self.forward(x, u)


def autodiff_grad_input(fwd: Callable, x: torch.Tensor, u: torch.Tensor):
    """Batched exact Jacobians ``(A (..., n, n), B (..., n, m))`` of
    ``fwd(x, u)``: the batch flattened, ``jacfwd`` mapped over single
    samples, and unflattened. Differentiable in the tensors ``fwd`` closes
    over."""
    batch, n, m = x.shape[:-1], x.shape[-1], u.shape[-1]
    A, B = vmap(jacfwd(fwd, argnums=(0, 1)))(x.reshape(-1, n), u.reshape(-1, m))
    return A.reshape(*batch, n, n), B.reshape(*batch, n, m)


@dataclasses.dataclass(frozen=True, eq=False)
class AffineDynamics(Dynamics):
    """``x_next = A x + B u + c`` with its exact ``grad_input``."""

    A: torch.Tensor  # (n, n) or (..., n, n)
    B: torch.Tensor  # (n, m) or (..., n, m)
    c: Optional[torch.Tensor] = None  # (n,) or (..., n)

    def forward(self, x, u):
        out = bmv(self.A, x) + bmv(self.B, u)
        return out if self.c is None else out + self.c

    def grad_input(self, x, u):
        batch, n, m = x.shape[:-1], x.shape[-1], u.shape[-1]
        return self.A.expand(*batch, n, n), self.B.expand(*batch, n, m)


def _elu(x):
    return torch.where(x > 0, x, torch.expm1(torch.where(x > 0, 0.0, x)))


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0); torch's softplus returns x itself
    # above its threshold of 20
    return torch.logaddexp(x, torch.zeros_like(x))


def _gelu(x):
    # jax.nn.gelu's default, the tanh form (torch's default is the erf form)
    return torch.nn.functional.gelu(x, approximate="tanh")


# The activations, in the order of enum NNActivation in csrc/nn_mlp.cuh
ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "elu": _elu,
    "softplus": _softplus,
    "gelu": _gelu,
}


@dataclasses.dataclass(frozen=True, eq=False)
class NNDynamics(Dynamics):
    """MLP state-transition model on ``[x; u]``.

    ``weights[i] (d_in, d_out)``, ``biases[i] (d_out,)``; the last layer
    outputs ``n_state``, every other layer goes through ``activation``.
    ``residual=True`` predicts a delta added to ``x``.
    """

    weights: Tuple[torch.Tensor, ...]
    biases: Tuple[torch.Tensor, ...]
    activation: str = "tanh"
    residual: bool = False

    # the fusable gate of the JAX package (dynamics.py:190-201): the kernels
    # keep the weights on chip and unroll the layers
    _FUSABLE_MAX_PARAMS = 1024
    _FUSABLE_MAX_WIDTH = 32

    @staticmethod
    def init(
        n_state: int,
        n_ctrl: int,
        hidden: Sequence[int] = (64, 64),
        activation: str = "tanh",
        residual: bool = False,
        dtype=torch.float32,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ) -> "NNDynamics":
        """He-normal weights (``N(0, 2 / d_in)``) and zero biases, drawn
        from ``generator`` (on ``device``), on the card unless ``device``
        says otherwise."""
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation must be one of {tuple(ACTIVATIONS)}; got {activation!r}")
        sizes = [n_state + n_ctrl, *hidden, n_state]
        ws, bs = [], []
        for a, b in zip(sizes[:-1], sizes[1:]):
            w = torch.randn((a, b), generator=generator, dtype=dtype, device=device)
            ws.append(w * math.sqrt(2.0 / a))
            bs.append(torch.zeros((b,), dtype=dtype, device=device))
        return NNDynamics(tuple(ws), tuple(bs), activation, residual)

    @property
    def n_state(self) -> int:
        return self.weights[-1].shape[1]

    @property
    def n_ctrl(self) -> int:
        return self.weights[0].shape[0] - self.n_state

    @property
    def hidden(self) -> tuple:
        return tuple(w.shape[1] for w in self.weights[:-1])

    @property
    def n_params(self) -> int:
        return sum(w.numel() for w in self.weights) + sum(b.numel() for b in self.biases)

    def forward(self, x, u):
        h = torch.cat([x, u], -1)
        act = ACTIVATIONS[self.activation]
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            # an elementwise product-sum, not a matrix product: no TF32
            h = (h[..., :, None] * w).sum(-2) + b
            if i < len(self.weights) - 1:
                h = act(h)
        return x + h if self.residual else h

    @property
    def kernel_fusable(self) -> bool:
        return self.n_params <= self._FUSABLE_MAX_PARAMS and all(h <= self._FUSABLE_MAX_WIDTH for h in self.hidden)

    def kernel_params(self) -> torch.Tensor:
        """Flat parameter vector: per layer, row-major ``W`` then ``b``, the
        order :meth:`entries_step` (and ``csrc/nn_mlp.cuh``) unpacks."""
        parts = []
        for w, b in zip(self.weights, self.biases):
            parts += [w.reshape(-1), b]
        return torch.cat(parts)

    def entries_step(self, params, x_entries, u_entries):
        """Entry-wise MLP step: each entry a ``(B,)`` tensor, ``params`` the
        flat scalars of :meth:`kernel_params` as 0-d tensors. Equal to
        :meth:`forward` in exact arithmetic. Unit j of a layer is
        ``sum_i W[i][j] h[i] + b[j]``, summed over i in order, as the JAX
        package's ``entries_step`` and ``csrc/nn_mlp.cuh`` sum it; each
        layer's units are computed side by side, a ``(d_out, B)`` tensor,
        which rounds every unit as its own sum would."""
        h = list(x_entries) + list(u_entries)
        act = ACTIVATIONS[self.activation]
        ones = (1,) * max(e.ndim for e in h)  # the units broadcast against the entries
        idx = 0
        for li, w in enumerate(self.weights):
            din, dout = w.shape
            W = torch.stack(params[idx : idx + din * dout]).reshape(din, dout, *ones)
            idx += din * dout
            bias = torch.stack(params[idx : idx + dout]).reshape(dout, *ones)
            idx += dout
            z = W[0] * h[0]
            for i in range(1, din):
                z = z + W[i] * h[i]
            z = z + bias
            if li < len(self.weights) - 1:
                z = act(z)
            h = list(z)
        if self.residual:
            h = [x_entries[i] + h[i] for i in range(len(x_entries))]
        return h


@dataclasses.dataclass(frozen=True, eq=False)
class CtrlPassthroughDynamics(Dynamics):
    """``inner`` with the control carried in the state: state
    ``[u_tilde; x]``, next state ``[u; inner(x, u)]``. The slew-rate
    penalty's formulation (``mpc._augment_slew``), where the cost must see
    the previous control.

    Its ``entries_step`` is the inner model's, composed, so a fusable inner
    model makes the augmented problem fusable too: the fused solve and the
    line search launch the inner env's C++ step wrapped by
    ``CtrlPassthroughEnv`` (``csrc/passthrough.cuh``), built as a variant
    of its own. Its tensors are the inner model's."""

    inner: Dynamics
    n_ctrl: int

    def forward(self, x, u):
        return torch.cat([u, self.inner.forward(x[..., self.n_ctrl :], u)], -1)

    def grad_input(self, x, u):
        """The inner model's Jacobians composed: ``A' = [[0, 0], [0, A]]``
        and ``B' = [[I], [B]]`` in the ``[u_tilde; x]`` layout."""
        m = self.n_ctrl
        A_i, B_i = self.inner.grad_input(x[..., m:], u)
        batch, n_i = x.shape[:-1], A_i.shape[-1]
        kw = dict(dtype=A_i.dtype, device=A_i.device)
        A_top = torch.zeros((*batch, m, m + n_i), **kw)
        A_bot = torch.cat([torch.zeros((*batch, n_i, m), **kw), A_i], -1)
        B_top = torch.eye(m, **kw).expand(*batch, m, m)
        return torch.cat([A_top, A_bot], -2), torch.cat([B_top, B_i], -2)

    @property
    def kernel_fusable(self) -> bool:
        return (
            hasattr(self.inner, "entries_step")
            and hasattr(self.inner, "kernel_params")
            and getattr(self.inner, "kernel_fusable", True)
        )

    def kernel_params(self) -> torch.Tensor:
        return self.inner.kernel_params()

    def entries_step(self, params, x_entries, u_entries):
        return list(u_entries) + list(self.inner.entries_step(params, x_entries[self.n_ctrl :], u_entries))

    def tensors(self) -> list:
        return self.inner.tensors()

    def to(self, dtype=None, device=None):
        return self.replace(inner=self.inner.to(dtype, device))
