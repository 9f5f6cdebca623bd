"""Numerical guards (counterpart of :mod:`diffmpc_tpu.utils.debug`).

The debugging story of the solve is numerical: a NaN or an infinity in its
output. ``debug_nans`` turns on autograd's anomaly detection, which names the
operation whose backward produced the first NaN; ``checked_solve`` wraps a
solve so that it returns an error beside its output when any float tensor of
the output is not finite (``torch.isfinite``).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """While inside, autograd's anomaly detection is ``enable``d: a backward
    that produces a NaN raises, naming the forward operation that it came
    from. Restores the previous setting on exit."""
    old = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(enable)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(old)


class SolveCheckError(RuntimeError):
    """A non-finite value in a checked solve's output."""


class CheckResult:
    """What a checked solve found: ``error`` is None when every float tensor
    of the output was finite, else a :class:`SolveCheckError` naming the
    first one that was not; :meth:`throw` raises it."""

    def __init__(self, error: Optional[SolveCheckError]):
        self.error = error

    def get(self) -> Optional[str]:
        return None if self.error is None else str(self.error)

    def throw(self) -> None:
        if self.error is not None:
            raise self.error


def _leaves(out, path="out"):
    """``(path, tensor)`` for every tensor of a nest of tuples, lists,
    dicts and named tuples."""
    if isinstance(out, torch.Tensor):
        yield path, out
    elif isinstance(out, dict):
        for k, v in out.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(out, (tuple, list)):
        names = getattr(out, "_fields", None) or range(len(out))
        for k, v in zip(names, out):
            yield from _leaves(v, f"{path}.{k}" if isinstance(k, str) else f"{path}[{k}]")


def checked_solve(solve_fn):
    """Wrap a solve so that it returns ``(check, output)``: ``check`` a
    :class:`CheckResult` whose error names the first float tensor of the
    output with a NaN or an infinity. The check reads one flag a tensor on
    the host.

    Example::

        checked = checked_solve(lambda x: mpc_solve(config, x, cost, dx))
        check, sol = checked(x_init)
        check.throw()  # raises if any output was not finite
    """

    def wrapped(*args, **kwargs):
        out = solve_fn(*args, **kwargs)
        for path, leaf in _leaves(out):
            if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
                return CheckResult(SolveCheckError(f"non-finite value in solve output {path}")), out
        return CheckResult(None), out

    return wrapped
