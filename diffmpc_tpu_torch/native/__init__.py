"""The float64 C++ oracle (counterpart of :mod:`diffmpc_tpu.native`).

A host oracle by design: ``native/diffmpc_native.cpp`` of the repository (a
standalone double-precision box-DDP iLQR solve that shares no code with
either package) built with g++ at first use and called through ctypes on
the CPU, one scenario after another. It is the independent reference that
the port's solves are held to (``tests/test_torch_native.py``;
``chip_smoke.py``, phase 40, for the card's config 2 solve), not a path of
the solver: it never runs on the card.

The source is read by path from the repository root; the library is built
into ``diffmpc_tpu_torch/_build/native/`` (compiled to a name of its own
process, then renamed into place, so that processes building at once never
load a partly written file).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "diffmpc_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build", "native")

_lib = None


def _load():
    """The built library, built first where it is missing or older than the
    source."""
    global _lib
    if _lib is not None:
        return _lib
    so = os.path.join(BUILD_DIR, "libdiffmpc_native.so")
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(SOURCE):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", tmp, SOURCE], check=True, timeout=300)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    d = ctypes.POINTER(ctypes.c_double)
    lib.diffmpc_solve_batch.restype = None
    lib.diffmpc_solve_batch.argtypes = [
        d, d, d, d, d, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, d, d,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_double, d, d, d,
    ]
    _lib = lib
    return lib


def _host(a) -> np.ndarray:
    """A CPU tensor or an array as float64 numpy; a tensor on the card is
    refused: the oracle reads the host's copy, which the caller makes."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"native.solve_batch is a host oracle: pass CPU tensors, not {a.device}")
        a = a.detach().numpy()
    return np.asarray(a, np.float64)


def solve_batch(
    C, c, F, f, x_init,
    u_lower=None,
    u_upper=None,
    ilqr_iter: int = 30,
    pnqp_iter: int = 20,
    ls_decay: float = 0.2,
    ls_iter: int = 10,
    reg: float = 1e-9,
):
    """Solve a batch of affine-dynamics, optionally box-constrained iLQR
    problems in float64 on the host: ``C (T,B,nm,nm)``, ``c (T,B,nm)``,
    ``F (T,B,n,nm)``, ``f (T,B,n)``, ``x_init (B,n)``, bounds broadcastable
    to ``(T,B,m)`` or None, as CPU tensors or arrays. Returns ``(xs (T,B,n),
    us (T,B,m), objs (B,))`` as float64 CPU tensors."""
    lib = _load()
    C, c, F, f, x0 = (_host(a) for a in (C, c, F, f, x_init))
    T, B, nm = c.shape
    n = x0.shape[-1]
    m = nm - n
    constrained = u_lower is not None

    def per_scenario(a):  # (T, B, ...) -> contiguous (B, T, ...)
        return np.ascontiguousarray(np.moveaxis(a, 1, 0))

    Cb, cb, Fb, fb = (per_scenario(a) for a in (C, c, F, f))
    x0 = np.ascontiguousarray(x0)
    lo = hi = None
    if constrained:
        lo, hi = (per_scenario(np.broadcast_to(_host(b), (T, B, m))) for b in (u_lower, u_upper))
    xs, us, objs = np.zeros((B, T, n)), np.zeros((B, T, m)), np.zeros(B)

    def ptr(a: Optional[np.ndarray]):
        return None if a is None else a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    lib.diffmpc_solve_batch(ptr(Cb), ptr(cb), ptr(Fb), ptr(fb), ptr(x0), T, B, n, m, ptr(lo), ptr(hi),
                            int(constrained), ilqr_iter, pnqp_iter, ls_decay, ls_iter, reg, ptr(xs), ptr(us),
                            ptr(objs))
    return (torch.from_numpy(np.ascontiguousarray(np.moveaxis(xs, 0, 1))),
            torch.from_numpy(np.ascontiguousarray(np.moveaxis(us, 0, 1))), torch.from_numpy(objs))
