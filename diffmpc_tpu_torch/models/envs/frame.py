"""What the envs' ``get_frame`` share: the state and the params of one frame
as host numpy arrays, and the refusal of a model with per-scenario params.
matplotlib itself is imported inside each ``get_frame``, so that importing
an env never needs it."""

from __future__ import annotations

import numpy as np
import torch

ONE_INSTANCE = (
    "get_frame renders one instance; select a scenario row "
    "first: dx.replace(params=dx.params[b]).get_frame(x[b])"
)


def host(a) -> np.ndarray:
    """``a`` as a numpy array: a tensor on any device is copied to the host."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def frame_inputs(dx, x) -> tuple:
    """``(x, params)`` of one frame of ``dx`` as host numpy arrays; a model
    whose params are per scenario raises ``ValueError``."""
    if dx.param_batch_shape:
        raise ValueError(ONE_INSTANCE)
    return host(x), host(dx.params)
