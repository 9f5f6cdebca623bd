"""The fused analytic KKT backward: CUDA kernel wrapper and plain version.

Counterpart of :func:`diffmpc_tpu.ops.pallas.kkt.kkt_backward_fused`, the
TPU kernel that runs the whole backward of the differentiable LQR fixed
point for a tile of scenarios: the auxiliary Riccati with tight control
dims frozen, the differential rollout ``p`` with the cost gradients, and the
multiplier recursions with the dynamics gradients.

- :func:`kkt_backward_fused` is the public entry point. For CUDA tensors it
  launches the kernel of ``csrc/kkt.cu`` (a group of L threads per scenario,
  L by :func:`kkt_lanes`; a C or F shared by every scenario read in place,
  :func:`reads_in_place`), or its streaming twin
  (:mod:`~diffmpc_tpu_torch.ops.cuda.kkt_stream`) where the
  JAX package takes that, or raises; for CPU tensors it runs
  :func:`kkt_backward_plain`.
- :func:`kkt_backward_plain` is the same algorithm in plain PyTorch,
  vectorized over the batch: each matrix entry is a ``(B,)`` tensor and
  Python loops run over time and entries. It computes in the dtype of
  ``C`` (the kernels, like the TPU kernel, in float32), for any ``(n, m)``.

The public layout is the JAX wrapper's: ``C (T,B,nm,nm)``, ``c (T,B,nm)``,
``F (T,B,n,nm)``, ``r (T,B,nm)`` (the incoming trajectory gradient with
tight control dims zeroed), ``tau (T,B,nm)`` (the primal trajectory),
``tight (T,B,m)`` bool. Every function returns
``(dx_init (B,n), dC, dc, dF, df (T,B,n))`` in the dtype of ``C``. With
``value_update_exact_reg`` at or above ``reg`` the auxiliary sweep takes the
simplified value update (:func:`kkt_exact_update`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .horizon import streams_kkt
from .ilqr import _sm_count, bm, kernel_symbol, resolve_use_cuda
from .riccati_entries import _masked_chol_solve, _value_update


def _check_shapes(C, c, F, r, tau, tight):
    if C.ndim != 4 or C.shape[2] != C.shape[3]:
        raise ValueError(f"C must be (T, B, nm, nm); got {tuple(C.shape)}")
    T, B, nm = C.shape[0], C.shape[1], C.shape[-1]
    if tight.ndim != 3 or tight.shape[:2] != (T, B):
        raise ValueError(f"tight must be (T={T}, B={B}, m); got {tuple(tight.shape)}")
    m = tight.shape[-1]
    n = nm - m
    if n < 1 or m < 1:
        raise ValueError(f"C's trailing dim {nm} does not split into n >= 1 and m = {m} >= 1")
    for name, a, shape in (
        ("c", c, (T, B, nm)), ("F", F, (T, B, n, nm)), ("r", r, (T, B, nm)),
        ("tau", tau, (T, B, nm)),
    ):
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(a.shape)}")
    return T, B, n, m


def kkt_exact_update(reg: float, threshold: float) -> bool:
    """Whether the auxiliary Riccati sweep takes the simplified value update:
    the JAX kernel's gate (``kkt.py:105``, ``_use_exact_value_update`` in mask
    mode, where the gains are exact masked solves, so only ``reg`` gates it)
    with ``VALUE_UPDATE_EXACT_REG`` as ``threshold``."""
    return reg <= threshold


# ---------------------------------------------------------------------------
# The plain PyTorch version.
# ---------------------------------------------------------------------------


@torch.no_grad()
def kkt_backward_plain(
    C: torch.Tensor,
    c: torch.Tensor,
    F: torch.Tensor,
    r: torch.Tensor,
    tau: torch.Tensor,
    tight: torch.Tensor,
    *,
    reg: float = 1e-7,
    value_update_exact_reg: float = -1.0,
):
    """The fused KKT backward in plain PyTorch, on any device and for any
    ``(n, m)``; same contract as :func:`kkt_backward_fused`."""
    T, B, n, m = _check_shapes(C, c, F, r, tau, tight)
    exact = kkt_exact_update(reg, value_update_exact_reg)
    nm = n + m
    dtype = C.dtype
    # entry views: Ce[t, a, b] and friends are (B,) tensors
    Ce = C.to(dtype).permute(0, 2, 3, 1)
    ce = c.to(dtype).permute(0, 2, 1)
    Fe = F.to(dtype).permute(0, 2, 3, 1)
    re = r.to(dtype).permute(0, 2, 1)
    taue = tau.to(dtype).permute(0, 2, 1)
    tighte = tight.to(dtype).permute(0, 2, 1)
    zero = torch.zeros(B, dtype=dtype, device=C.device)

    # ---- 1. auxiliary Riccati, tight dims frozen (linear term = r) ----
    K_g, k_g = [None] * T, [None] * T
    V = [[zero] * n for _ in range(n)]
    v = [zero] * n
    for t in reversed(range(T)):
        Ft = [[Fe[t, a, j] for j in range(nm)] for a in range(n)]
        W = [
            [sum(V[k][l] * Ft[l][j] for l in range(n)) for j in range(nm)]
            for k in range(n)
        ]
        Q = [[None] * nm for _ in range(nm)]
        for a in range(nm):
            for b in range(a, nm):
                val = Ce[t, a, b] + sum(Ft[k][a] * W[k][b] for k in range(n))
                Q[a][b] = val
                Q[b][a] = val
        q = [re[t, a] + sum(Ft[k][a] * v[k] for k in range(n)) for a in range(nm)]
        Quu = [[Q[n + a][n + b] for b in range(m)] for a in range(m)]
        qu = [q[n + a] for a in range(m)]
        frozen = [tighte[t, a] for a in range(m)]
        rhs_cols = [[Q[n + a][b] for a in range(m)] for b in range(n)] + [qu]
        sols = _masked_chol_solve(Quu, rhs_cols, frozen, m, reg)
        K_g[t] = [[-sols[b][a] for b in range(n)] for a in range(m)]
        k_g[t] = [-sols[n][a] for a in range(m)]
        V, v = _value_update(Q, q, Quu, qu, K_g[t], k_g[t], n, m, exact)

    # ---- 2. differential rollout p (f = 0, p_x0 = 0), dC and dc ----
    p_all, dC_all = [], []
    px = [zero] * n
    for t in range(T):
        pu = [k_g[t][a] + sum(K_g[t][a][j] * px[j] for j in range(n)) for a in range(m)]
        p = px + pu
        ta = [taue[t, a] for a in range(nm)]
        dC = [[None] * nm for _ in range(nm)]
        for a in range(nm):
            for b in range(a, nm):
                val = 0.5 * (p[a] * ta[b] + ta[a] * p[b])
                dC[a][b] = val
                dC[b][a] = val
        p_all.append(p)
        dC_all.append(dC)
        px = [sum(Fe[t, i, j] * p[j] for j in range(nm)) for i in range(n)]

    # ---- 3. multipliers lam, mu (backward), dF, df, dx_init ----
    dF_all, df_all = [None] * T, [None] * T
    lam, mu = [zero] * n, [zero] * n  # lam_{t+1}, mu_{t+1}
    for t in reversed(range(T)):
        p = p_all[t]
        ta = [taue[t, a] for a in range(nm)]
        dF_all[t] = [[-(mu[i] * ta[j] + lam[i] * p[j]) for j in range(nm)] for i in range(n)]
        df_all[t] = [-mu[i] for i in range(n)]
        lam_t = [
            -(sum(Ce[t, a, b] * ta[b] for b in range(nm)) + ce[t, a])
            + sum(Fe[t, k, a] * lam[k] for k in range(n))
            for a in range(n)
        ]
        mu_t = [
            -(sum(Ce[t, a, b] * p[b] for b in range(nm)) + re[t, a])
            + sum(Fe[t, k, a] * mu[k] for k in range(n))
            for a in range(n)
        ]
        lam, mu = lam_t, mu_t

    def grid(rows):  # nested lists of (B,) entries -> (B, *dims)
        if isinstance(rows, torch.Tensor):
            return rows
        return torch.stack([grid(x) for x in rows], 1)

    dx_init = -grid(mu)
    dC, dc, dF, df = (torch.stack([grid(x) for x in seq]) for seq in (dC_all, p_all, dF_all, df_all))
    return dx_init, dC, dc, dF, df


# ---------------------------------------------------------------------------
# The CUDA kernel.
# ---------------------------------------------------------------------------


class _KktArgs(ctypes.Structure):
    """ctypes mirror of ``struct KktArgs`` in ``csrc/kkt.cuh``."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "C", "c", "F", "r", "tau", "tight",
            "dx_init", "dC", "dc", "dF", "df", "K", "k",
        )
    ] + [
        ("T", ctypes.c_int), ("B", ctypes.c_int), ("reg", ctypes.c_float), ("lanes", ctypes.c_int),
        ("on_chip", ctypes.c_int), ("prefetch", ctypes.c_int),
    ] + [(name, ctypes.c_longlong) for name in ("C_t", "C_e", "C_b", "F_t", "F_e", "F_b")]


# The lane counts the card's kernels are built for (DMPC_KKT_LANES in
# csrc/kkt_launch.cuh, the files csrc/kkt_l<L>.cu): the two that the rule
# below picks. The tests' host build also runs 2 and 4 (DMPC_LANES).
KKT_LANES = (1, 16)


# The rule's measurements: the kernels alone on the KKT call of one solve +
# gradient, ms, by CUDA events on an NVIDIA H100 80GB HBM3 at 700 W (132
# SMs), at L = 1 / 16 (diagnostics/ab_kkt_lanes; PERF.md, rows 2 and 7):
#   the pendulum (n=3, m=1), T=20, B = 128: 0.0220 0.0287; 256: 0.0227
#     0.0293; 1024: 0.0221 0.0334; 4096: 0.0226 0.0774; 65536: 0.1790 0.8946;
#   config 2 (n=4, m=2), T=20, B = 128: 0.0976 0.0619; 1024: 0.0979 0.0695;
#     4096: 0.1123 0.2013; 16384: 0.1631 0.5464;
#   the same at T=128 (the twin), B = 128: 0.5957 0.3718; 1024: 0.6924
#     0.4497; 4096: 0.7590 1.2612;
#   (6, 3) LinDx, T=20, B = 1024: 0.3166 0.1225; 4096: 0.3527 0.3300; the
#     (6, 3) MLP's imitation gradient, B = 1024: 0.3064 0.1257; 4096: 0.3348
#     0.3478.
# Sixteen lanes pay while the step has a control block to share (m >= 2)
# and B * 16 threads leave the card's SMs room (256 threads an SM: 2112
# scenarios on 132 SMs); the m = 1 step (a scalar masked solve) is too short
# to share: one lane wins at every batch measured. Two and four lanes
# (measured on an earlier build of the step) never beat both one and
# sixteen, and are not built.
KKT_THREADS_PER_SM = 256


def kkt_lanes(B: int, n: int, m: int, sm_count: int, T: int) -> int:
    """The threads per scenario of the KKT kernels for a batch of ``B``
    scenarios at ``(n, m)`` over ``T`` steps on a card of ``sm_count`` SMs:
    one for m = 1; else 16 while ``B * 16`` stays within
    :data:`KKT_THREADS_PER_SM` threads an SM, past that one. The horizon does
    not enter: the measurements at T=20 and 128 pick alike."""
    if m == 1:
        return 1
    return 16 if B * 16 <= KKT_THREADS_PER_SM * sm_count else 1


def reads_in_place(a: torch.Tensor) -> bool:
    """Whether the kernels read ``a`` (C ``(T,B,nm,nm)`` or F ``(T,B,n,nm)``)
    where it lies: one matrix for every scenario (a batch stride of 0, as
    ``expand`` gives), each step's matrix contiguous."""
    return a.shape[1] > 0 and a.stride(1) == 0 and a[0, 0].is_contiguous()


class StagedKkt(NamedTuple):
    """A KKT backward staged for its kernels: the ``KktArgs`` struct, the
    buffers the kernel writes (the outputs, then the gains' scratch ``K, k``)
    and the tensors the struct points into, which must outlive every
    launch."""

    args: ctypes.Structure
    outputs: tuple  # dx_init (n, B), dC (T, nm, nm, B), dc (T, nm, B), dF (T, n, nm, B), df (T, n, B)
    scratch: tuple  # K (T, m, n, B), k (T, m, B)
    buffers: tuple

    def result(self):
        """The outputs of the last launch, in the public layout."""
        dx_init, dC, dc, dF, df = self.outputs
        return (dx_init.t(), dC.permute(0, 3, 1, 2), dc.permute(0, 2, 1), dF.permute(0, 3, 1, 2),
                df.permute(0, 2, 1))

    def gains(self):
        """The auxiliary sweep's ``K (T,B,m,n)``, ``k (T,B,m)`` of the last
        launch, where it kept them in device memory (``on_chip`` 0)."""
        K, k = self.scratch
        return K.permute(0, 3, 1, 2), k.permute(0, 2, 1)


def stage_kkt(C, c, F, r, tau, tight, *, reg: float = 1e-7, lanes: int = 1, on_chip=None, prefetch=None,
              in_place: bool = True) -> StagedKkt:
    """Stage the inputs batch-minor (with ``in_place``, a C or F that
    :func:`reads_in_place` stays where it lies) and allocate the outputs and
    the gains' scratch for a launch of ``kkt_backward_group<n, m>`` for
    every scenario with
    ``lanes`` threads per scenario, K, k and p kept ``on_chip`` or in device
    memory (None leaves it to the resident kernel's launcher, which writes its
    choice into the args; the twin and one lane keep them in device memory),
    one lane's slices loaded a step ahead (``prefetch``; None: the
    launcher's choice, written back). Float32 inputs only (``tight``
    bool)."""
    T, B, n, m = _check_shapes(C, c, F, r, tau, tight)
    nm = n + m
    device = C.device
    for name, a in (("C", C), ("c", c), ("F", F), ("r", r), ("tau", tau), ("tight", tight)):
        if a.dtype != (torch.bool if name == "tight" else torch.float32):
            raise TypeError(f"the KKT kernel takes float32 tensors and a bool tight; {name} is {a.dtype}")
        if a.device != device:
            raise ValueError(f"tensors on {a.device} and {device}")

    def strided(a):  # (buffer, its (step, entry, batch) strides in elements)
        if in_place and reads_in_place(a):
            return a, (a.stride(0), 1, 0)
        entries = a.shape[2] * a.shape[3]
        return bm(a), (entries * B, B, 1)

    (Cs, C_strides), (Fs, F_strides) = strided(C), strided(F)
    ins = [Cs, bm(c), Fs, bm(r), bm(tau), bm(tight.to(torch.float32))]
    f32 = dict(dtype=torch.float32, device=device)
    outputs = (
        torch.empty((n, B), **f32), torch.empty((T, nm, nm, B), **f32), torch.empty((T, nm, B), **f32),
        torch.empty((T, n, nm, B), **f32), torch.empty((T, n, B), **f32),
    )
    scratch = (torch.empty((T, m, n, B), **f32), torch.empty((T, m, B), **f32))
    args = _KktArgs(*(a.data_ptr() for a in ins + list(outputs + scratch)), T, B, reg, lanes,
                    -1 if on_chip is None else int(on_chip), -1 if prefetch is None else int(prefetch),
                    *C_strides, *F_strides)
    return StagedKkt(args, outputs, scratch, tuple(ins))


def run_staged_kkt(launch, C, c, F, r, tau, tight, *, reg: float = 1e-7, lanes: int = 1, on_chip=None,
                   prefetch=None):
    """Stage the inputs (:func:`stage_kkt`, with its knobs), call
    ``launch(args, n, m)`` with a pointer to the ``KktArgs`` struct, and
    return ``(dx_init, dC, dc, dF, df)`` in the public layout.

    ``launch`` runs ``kkt_backward_group<n, m>`` for every scenario: the
    CUDA launcher for CUDA tensors, or a host build of the same header for
    CPU tensors (the tests do that)."""
    staged = stage_kkt(C, c, F, r, tau, tight, reg=reg, lanes=lanes, on_chip=on_chip, prefetch=prefetch)
    launch(ctypes.byref(staged.args), F.shape[2], tight.shape[-1])
    # The staged inputs and the scratch are freed when this returns, while
    # the kernel may still run: PyTorch's caching allocator reuses a block
    # only in stream order, and the kernel runs on the current stream.
    return staged.result()


def _cuda_launcher(device: torch.device, n: int, m: int, kind: str = "kkt_backward", counted=None,
                   exact: bool = False):
    """The launcher of kernel ``kind`` (``kkt_backward`` or its streaming twin
    ``kkt_backward_stream``: the same ``KktArgs``) with the value update's
    form ``exact`` on the current stream, from the prebuilt library or the
    variant's (``ilqr.kernel_symbol``); a lane count that is not built makes
    the launch fail, and the launcher raise. Each launch adds one to
    ``counted.launches`` (default :func:`kkt_backward_fused`) and sets
    ``counted.last_lanes`` and ``counted.last_on_chip`` to the lane count it
    launched and whether it kept K, k and p on chip."""
    fn = kernel_symbol(kind, n, m, [ctypes.POINTER(_KktArgs), ctypes.c_void_p], exact=exact)
    stream = torch.cuda.current_stream(device).cuda_stream
    counted = kkt_backward_fused if counted is None else counted

    def launch(args, n, m):
        err = fn(args, stream)
        if err != 0:
            raise RuntimeError(f"{kind} kernel launch failed: cudaError {err} (lanes built: {KKT_LANES})")
        counted.launches += 1
        counted.last_lanes = args._obj.lanes
        counted.last_on_chip = bool(args._obj.on_chip)

    return launch


def run_on_card(launcher, C, c, F, r, tau, tight, *, reg: float = 1e-7, value_update_exact_reg: float = -1.0,
                lanes: Optional[int] = None):
    """Run a KKT kernel on CUDA tensors of any float dtype:
    ``launcher(device, n, m, exact=...)`` gives the launch of the value
    update's form (:func:`kkt_exact_update`), at ``lanes`` threads per
    scenario (None: :func:`kkt_lanes`); the inputs are cast to float32 and
    the gradients come back in ``C.dtype``. A float32 C or F that serves every
    scenario is read in place. CPU tensors raise."""
    resolve_use_cuda(True, C.device)
    T, B, n, m = _check_shapes(C, c, F, r, tau, tight)
    if lanes is None:
        lanes = kkt_lanes(B, n, m, _sm_count(C.device.index), T)
    dtype = C.dtype
    f32 = [a.to(torch.float32) for a in (C, c, F, r, tau)]
    exact = kkt_exact_update(reg, value_update_exact_reg)
    with torch.cuda.device(C.device):
        out = run_staged_kkt(launcher(C.device, n, m, exact=exact), *f32, tight, reg=reg, lanes=lanes)
    return tuple(x.to(dtype) for x in out)


def kkt_backward_fused(
    C: torch.Tensor,
    c: torch.Tensor,
    F: torch.Tensor,
    r: torch.Tensor,
    tau: torch.Tensor,
    tight: torch.Tensor,
    *,
    reg: float = 1e-7,
    value_update_exact_reg: float = -1.0,
    use_cuda: Optional[bool] = None,
):
    """Fused analytic KKT backward for a batch of solved problems; the
    contract of the JAX package's ``kkt_backward_fused``, with
    ``value_update_exact_reg`` its ``VALUE_UPDATE_EXACT_REG``. Returns
    ``(dx_init, dC, dc, dF, df)`` in ``C.dtype``; the backward itself runs
    in float32.

    CUDA tensors launch a kernel (prebuilt for the ``(n, m)`` of
    :data:`~diffmpc_tpu_torch.ops.cuda.ilqr.KERNEL_SHAPES` and the full value
    update; any other shape or the simplified update builds its variant at
    first use): this module's, adding one to ``kkt_backward_fused.launches``,
    or, where the horizon takes the JAX package's streaming twin
    (:func:`~diffmpc_tpu_torch.ops.cuda.horizon.streams_kkt`), the twin's
    (:func:`~diffmpc_tpu_torch.ops.cuda.kkt_stream.kkt_backward_stream_cuda`).
    CPU tensors run :func:`kkt_backward_plain`. See
    :func:`~diffmpc_tpu_torch.ops.cuda.ilqr.resolve_use_cuda`."""
    kw = dict(reg=reg, value_update_exact_reg=value_update_exact_reg)
    if not resolve_use_cuda(use_cuda, C.device):
        return kkt_backward_plain(C, c, F, r, tau, tight, **kw)
    T, _, n, m = _check_shapes(C, c, F, r, tau, tight)
    if streams_kkt(T, n, m):
        # the twin's module imports this one, so it is imported here
        from .kkt_stream import kkt_backward_stream_cuda

        return kkt_backward_stream_cuda(C, c, F, r, tau, tight, **kw)
    return run_on_card(_cuda_launcher, C, c, F, r, tau, tight, **kw)


kkt_backward_fused.launches = 0  # kernel launches, counted where they happen
kkt_backward_fused.last_lanes = None  # the lane count of the last launch
kkt_backward_fused.last_on_chip = None  # whether the last launch kept K, k and p on chip
