"""Models and costs as ``(class name, statics, tensors)``, and back.

A custom op (:mod:`diffmpc_tpu_torch.ops.library`) takes tensors, numbers
and strings, not objects, and an exported program
(:mod:`diffmpc_tpu_torch.aot`) must rebuild its model without the caller's
code. :func:`encode` splits a model into its class name, its static fields
as canonical JSON and the list of its tensors (the idea of
``convert.py``'s ``_env_from_jax``: the dataclass's statics apart from its
arrays); :func:`decode` rebuilds it from the three.

Covered: the five envs, :class:`NNDynamics` (its architecture in the
statics), :class:`AffineDynamics`, :class:`CtrlPassthroughDynamics` (the
inner model nested in the statics), ``LinDx`` and ``QuadCost``. A field
holds a tensor, a tuple of tensors, a number, a string, a bool, None or a
nested model.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from typing import List, Tuple

import torch

from ..types import LinDx, QuadCost
from .dynamics import AffineDynamics, CtrlPassthroughDynamics, NNDynamics
from .envs import AcrobotDx, CartpoleDx, PendulumDx, QuadrotorDx, VehicleDx

CLASSES = {
    cls.__name__: cls
    for cls in (PendulumDx, CartpoleDx, VehicleDx, QuadrotorDx, AcrobotDx, NNDynamics, AffineDynamics,
                CtrlPassthroughDynamics, LinDx, QuadCost)
}


def _field_names(obj) -> list:
    if dataclasses.is_dataclass(obj):
        return [f.name for f in dataclasses.fields(obj)]
    return list(obj._fields)  # a NamedTuple


def has_codec(obj) -> bool:
    """Whether :func:`encode` takes ``obj`` (its class is one of
    :data:`CLASSES`)."""
    return CLASSES.get(type(obj).__name__) is type(obj)


def _class_of(obj) -> str:
    if not has_codec(obj):
        raise TypeError(f"no codec for {type(obj).__qualname__}; known: {sorted(CLASSES)}")
    return type(obj).__name__


def _encode_value(v, tensors: list, paths: list, path: str):
    if isinstance(v, torch.Tensor):
        tensors.append(v)
        paths.append(path)
        return {"tensor": len(tensors) - 1}
    if has_codec(v):  # before tuples: LinDx and QuadCost are NamedTuples
        return {"model": type(v).__name__, "fields": _encode_fields(v, tensors, paths, path + ".")}
    if isinstance(v, (tuple, list)):
        return {"seq": [_encode_value(a, tensors, paths, f"{path}[{i}]") for i, a in enumerate(v)]}
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise TypeError(f"no codec for a field of type {type(v).__qualname__} at {path!r}; known models: {sorted(CLASSES)}")


def _encode_fields(obj, tensors: list, paths: list, prefix: str = "") -> dict:
    return {k: _encode_value(getattr(obj, k), tensors, paths, prefix + k) for k in _field_names(obj)}


def encode(obj) -> Tuple[str, str, List[torch.Tensor]]:
    """``(class name, statics JSON, tensors)`` of a model or cost."""
    name, statics, tensors, _ = encode_with_paths(obj)
    return name, statics, tensors


def encode_with_paths(obj):
    """:func:`encode` and each tensor's field path (``params``,
    ``weights[0]``, ``inner.params``, ...)."""
    tensors, paths = [], []
    fields = _encode_fields(obj, tensors, paths)
    return _class_of(obj), json.dumps(fields, sort_keys=True), tensors, paths


def _decode_value(v, tensors):
    if isinstance(v, dict):
        if "tensor" in v:
            return tensors[v["tensor"]]
        if "seq" in v:
            return tuple(_decode_value(a, tensors) for a in v["seq"])
        return CLASSES[v["model"]](**{k: _decode_value(a, tensors) for k, a in v["fields"].items()})
    return v


@functools.lru_cache(maxsize=256)
def _parse(statics: str) -> dict:
    """The statics of one model, parsed once: an op call decodes the same
    string at every step."""
    return json.loads(statics)


def decode(name: str, statics: str, tensors) -> object:
    """The model or cost that :func:`encode` split, with ``tensors`` in
    place of its own (same order, shapes and meaning)."""
    tensors = list(tensors)
    return CLASSES[name](**{k: _decode_value(v, tensors) for k, v in _parse(statics).items()})
