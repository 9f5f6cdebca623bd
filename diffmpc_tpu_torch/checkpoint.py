"""Save and resume a training run (counterpart of :mod:`diffmpc_tpu.checkpoint`).

A checkpoint is one ``torch.save`` file, ``path/step_<N>``, of the learnable
params' leaves (in :func:`~diffmpc_tpu_torch.utils.tree.tree_leaves`
order, with the tree's skeleton), the optimizer's ``state_dict()`` and the
step. The JAX package saves the same state with Orbax; the port needs
nothing beyond ``torch``. A save is written under a temporary name and
renamed into place, so an interrupted save never shows as the latest step.
The solver keeps no state between steps, so nothing else is saved.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

from .utils.tree import tree_leaves

_PREFIX = "step_"


def _skeleton(tree):
    """``tree``'s containers with every leaf replaced by None (dicts keyed
    in sorted order, tuples and lists kept apart)."""
    if isinstance(tree, dict):
        return {k: _skeleton(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_skeleton(v) for v in tree)
    return None


def _steps(path: str) -> list:
    """The steps saved under ``path``, ascending; temporaries and other
    names do not count."""
    if not os.path.isdir(path):
        return []
    return sorted(int(d[len(_PREFIX):]) for d in os.listdir(path)
                  if d.startswith(_PREFIX) and d[len(_PREFIX):].isdigit())


def save_checkpoint(path: str, state, step: int, keep: int = 3) -> str:
    """Save ``state`` (a ``TrainState``: ``params``, a tensor or a pytree of
    them, and ``opt_state``, the optimizer over their leaves) as
    ``path/step_<step>``, and remove all but the newest ``keep`` steps.
    Returns the file's path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, f"{_PREFIX}{step}")
    payload = {
        "step": int(step),
        "skeleton": _skeleton(state.params),
        "params": [leaf.detach() for leaf in tree_leaves(state.params)],
        "optimizer": state.opt_state.state_dict(),
    }
    tmp = f"{target}.tmp-{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, target)
    for old in _steps(path)[:-keep] if keep > 0 else []:
        old_path = os.path.join(path, f"{_PREFIX}{old}")
        if os.path.isdir(old_path):
            shutil.rmtree(old_path, ignore_errors=True)
        else:
            os.remove(old_path)
    return target


def latest_step(path: str) -> Optional[int]:
    """The newest step saved under ``path``, or None."""
    steps = _steps(path)
    return steps[-1] if steps else None


def restore_checkpoint(path: str, like, step: Optional[int] = None):
    """Load ``path/step_<step>`` (the newest by default) into ``like``, a
    ``TrainState`` of the same tree: the params are copied into ``like``'s
    leaves in place (the optimizer holds those tensors), then the
    optimizer's state (Adam's moments and step) is loaded through
    ``load_state_dict``, keeping ``like``'s hyperparameters (the learning
    rate is the run's, as in the JAX package, where it lives in code).
    Loads with ``weights_only=True`` onto the device of ``like``'s leaves.
    A tree, shape or dtype that differs from ``like``'s raises
    ``ValueError``. Returns ``like``."""
    path = os.path.abspath(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    leaves = tree_leaves(like.params)
    saved = torch.load(os.path.join(path, f"{_PREFIX}{step}"), map_location=leaves[0].device, weights_only=True)
    if saved["skeleton"] != _skeleton(like.params):
        raise ValueError(f"checkpoint step {step}: its params tree {saved['skeleton']} is not the run's "
                         f"{_skeleton(like.params)}")
    for i, (leaf, value) in enumerate(zip(leaves, saved["params"])):
        if value.shape != leaf.shape or value.dtype != leaf.dtype:
            raise ValueError(f"checkpoint step {step}: leaf {i} is {tuple(value.shape)} {value.dtype}, the run's "
                             f"{tuple(leaf.shape)} {leaf.dtype}")
    opt = like.opt_state
    groups = opt.state_dict()["param_groups"]
    saved_state = saved["optimizer"]["state"]
    if any(k not in range(len(leaves)) for k in saved_state):
        raise ValueError(f"checkpoint step {step}: its optimizer state covers leaves {sorted(saved_state)} of "
                         f"{len(leaves)}")
    for k, entry in saved_state.items():
        for name, value in entry.items():
            if torch.is_tensor(value) and value.ndim and value.shape != leaves[k].shape:
                raise ValueError(f"checkpoint step {step}: {name} of leaf {k} is {tuple(value.shape)}, the run's "
                                 f"{tuple(leaves[k].shape)}")
    # Adam keeps its step count on the host unless it is capturable or fused
    # (then load_state_dict moves it to the params' device), as a fresh run does
    saved_state = {k: {name: v.cpu() if name == "step" and torch.is_tensor(v) else v for name, v in entry.items()}
                   for k, entry in saved_state.items()}
    with torch.no_grad():
        for leaf, value in zip(leaves, saved["params"]):
            leaf.copy_(value)
    opt.load_state_dict({"state": saved_state, "param_groups": groups})
    return like
