"""Which kernel a horizon takes: the resident kernels or their streaming twins.

The JAX package picks a streaming twin when a problem's horizon outgrows the
resident TPU kernel's VMEM budget (``diffmpc_tpu/ops/lqr_step.py:139-143``
for the Riccati sweep, ``:211-253`` for the line search, ``:342-352`` for the
KKT backward). The three predicates here give the same answer for every
``(T, n, m)``, from the port's own copy of the JAX package's byte formulas
(``diffmpc_tpu/ops/pallas/riccati.py:79-87``, ``:97-104``, ``:113-114``)
and its budget (``:55-59``: a tile of 1024 scenarios and 24 MiB).

These constants describe the TPU's VMEM. They are no limit of the H100: on
the card both the resident kernels and the twins read their horizon from
device memory, and either runs at any T. They are kept so that every shape
runs the same kernel function in both packages. The card's own crossover is
a measurement for later (``chip_smoke.py``, phase 18, times each twin
against its resident sibling at T = 20, 128 and 512).

Two choices of the JAX package are not followed (ROADMAP.md, section 3):
the fused iLQR kernel runs at any T (``mpc._would_use_fused``), and where the
JAX package takes its composite KKT backward (the resident Riccati fits, the
resident KKT kernel does not), the port keeps its resident KKT kernel, which
computes the same function.

Tests may monkeypatch :data:`VMEM_BUDGET_BYTES`: the predicates read it when
they are called.
"""

from __future__ import annotations

TILE_B = 8 * 128  # scenarios per TPU kernel instance: one (8, 128) tile
VMEM_BUDGET_BYTES = 24 * 1024 * 1024  # the resident kernels' per-tile budget


def riccati_vmem_bytes(T: int, n: int, m: int) -> int:
    """Per-tile VMEM of the resident Riccati kernel: its inputs (``C, c, F,
    f`` and the box) and outputs (``K, k, free``) over the horizon."""
    nm = n + m
    ins = T * (nm * nm + nm + n * nm + n + 2 * m)
    outs = T * (m * n + 2 * m)
    return (ins + outs) * 4 * TILE_B


def rollout_scratch_bytes(T: int, n: int, m: int) -> int:
    """Per-tile VMEM the resident line search keeps beyond the Riccati's
    (the reference trajectory and the candidate)."""
    return T * (2 * n + 3 * m) * 4 * TILE_B


def fits_vmem(T: int, n: int, m: int, extra: int = 0) -> bool:
    return riccati_vmem_bytes(T, n, m) + extra <= VMEM_BUDGET_BYTES


def streams_riccati(T: int, n: int, m: int) -> bool:
    """The Riccati sweep takes its streaming twin."""
    return not fits_vmem(T, n, m)


def streams_rollout(T: int, n: int, m: int) -> bool:
    """The line search takes its streaming twin."""
    return not fits_vmem(T, n, m, extra=rollout_scratch_bytes(T, n, m))


def streams_kkt(T: int, n: int, m: int) -> bool:
    """The KKT backward takes its streaming twin: where the resident Riccati
    does not fit (``lqr_step.py:344``). The resident KKT kernel needs more
    than the resident Riccati, so it never fits there either."""
    return streams_riccati(T, n, m)
