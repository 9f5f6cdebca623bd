"""Parallel-in-time Riccati backward pass (counterpart of
:mod:`diffmpc_tpu.ops.assoc_riccati`).

The unconstrained Riccati recursion is an associative composition of
conditional value functions (Sarkka & Garcia-Fernandez, temporal
parallelization of LQT). Each step ``t`` contributes an element
``e_t = (A, b, C, eta, J)`` built from its stage data alone, and element ``i``
followed by element ``j`` combine, with ``P = (I + C_i J_j)^-1``, as

    A_ij   = A_j P A_i
    b_ij   = A_j P (b_i + C_i eta_j) + b_j
    C_ij   = A_j P C_i A_j' + C_j
    eta_ij = A_i' P' (eta_j - J_j b_i) + eta_i
    J_ij   = A_i' P' J_j A_i + J_i.

The per-step element completes the square in ``u``:
``A_t = F_x - F_u Quu^-1 Qux``, ``b_t = f_t - F_u Quu^-1 qu``,
``C_t = F_u Quu^-1 F_u'``, ``J_t = Qxx - Qxu Quu^-1 Qux``,
``eta_t = -(qx - Qxu Quu^-1 qu)``; the last step has no outgoing transition
(``A, b, C = 0``). Suffix-combining ``t .. T-1`` gives
``V_t(x) = 0.5 x'J x - eta'x``, and the gains come from one batched solve
per step. Unconstrained only: active box sets couple the steps
non-associatively.

These are plain PyTorch functions in matrix form and launch no kernel. They
are the matrix-form reference of the element algebra that the depth-blocked
CUDA kernel (``csrc/riccati_blocked.cuh``) runs in entry form.

- :func:`riccati_backward_assoc`: the whole horizon by a reverse associative
  scan, written out with the odd/even recursion of
  ``jax.lax.associative_scan`` so that the same pairs combine in the same
  order as in the JAX package.
- :func:`riccati_backward_blocked`: ``n_blocks`` blocks of the horizon
  suffix-composed side by side, then joined: sequential depth ``T/D + D``.
- :func:`riccati_backward_time_sharded`: the same blocks over the ranks of a
  ``"time"`` mesh, one block a rank, each rank given only its block's time
  slice; the block totals are exchanged by one ``all_gather``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..utils.batch import bmm, bmv, btrans, symmetrize
from .cuda.riccati import RiccatiResult
from .smallchol import cho_solve_small, cholesky_small, solve_general_small


def _combine(e_i, e_j):
    """Associative combination, element ``e_i`` then ``e_j`` in time; both
    batched ``(..., n, n)`` / ``(..., n)``."""
    A1, b1, C1, eta1, J1 = e_i
    A2, b2, C2, eta2, J2 = e_j
    n = A1.shape[-1]
    eye = torch.eye(n, dtype=A1.dtype, device=A1.device)
    M = eye + bmm(C1, J2)  # (I + C_i J_j)
    rhs = torch.cat([A1, (b1 + bmv(C1, eta2))[..., None], C1], -1)
    sol = solve_general_small(M, rhs)
    PA1 = sol[..., :n]
    Pb = sol[..., n]
    PC1 = sol[..., n + 1 :]

    A = bmm(A2, PA1)
    b = bmv(A2, Pb) + b2
    C = symmetrize(bmm(A2, bmm(PC1, btrans(A2))) + C2)
    # (I + J_j C_i)^-1 = P': a solve with the transposed matrix
    rhs2 = torch.cat([(eta2 - bmv(J2, b1))[..., None], bmm(J2, A1)], -1)
    sol2 = solve_general_small(btrans(M), rhs2)
    eta = bmv(btrans(A1), sol2[..., 0]) + eta1
    J = symmetrize(bmm(btrans(A1), sol2[..., 1:]) + J1)
    return A, b, C, eta, J


def _build_elements(C, c, F, f, n, *, reg, zero_last=True):
    """The per-step elements (module docstring). ``zero_last=False`` skips the
    terminal step's zeroing of ``A, b, C``, for a caller that zeroes only the
    globally last step of several chunks."""
    Qxx = C[..., :n, :n]
    Qxu = C[..., :n, n:]
    Qux = C[..., n:, :n]
    Quu = C[..., n:, n:]
    qx = c[..., :n]
    qu = c[..., n:]
    Fx = F[..., :, :n]
    Fu = F[..., :, n:]

    chol_uu = cholesky_small(Quu, reg)
    iQuu_Qux = cho_solve_small(chol_uu, Qux)  # (T, B, m, n)
    iQuu_qu = cho_solve_small(chol_uu, qu[..., None])[..., 0]  # (T, B, m)
    iQuu_FuT = cho_solve_small(chol_uu, btrans(Fu))  # (T, B, m, n)

    A_el = Fx - bmm(Fu, iQuu_Qux)
    b_el = f - bmv(Fu, iQuu_qu)
    C_el = symmetrize(bmm(Fu, iQuu_FuT))
    J_el = symmetrize(Qxx - bmm(Qxu, iQuu_Qux))
    eta_el = -(qx - bmv(Qxu, iQuu_qu))

    if zero_last:
        # the last step: its stage cost only, no outgoing transition
        A_el, b_el, C_el = (torch.cat([e[:-1], torch.zeros_like(e[-1:])]) for e in (A_el, b_el, C_el))
    return A_el, b_el, C_el, eta_el, J_el


def _identity_element(batch, n, dtype, device=None):
    """The neutral element of :func:`_combine` (``A = I``, the rest 0).
    ``batch``: an int ``B`` or a tuple of leading dims (``(D, B)`` for the
    blocked form)."""
    bshape = (batch,) if isinstance(batch, int) else tuple(batch)
    kw = dict(dtype=dtype, device=device)
    eye = torch.eye(n, **kw).expand(bshape + (n, n))
    z_nn = torch.zeros(bshape + (n, n), **kw)
    z_n = torch.zeros(bshape + (n,), **kw)
    return eye, z_n, z_nn, z_n, z_nn


def _gains_from_value(C, c, F, f, V_next, v_next, n, reg):
    """The gains from the next step's value, one batched solve per step."""
    FtT = btrans(F)
    Q = symmetrize(C + bmm(FtT, bmm(V_next, F)))
    q = c + bmv(FtT, bmv(V_next, f) + v_next)
    chol = cholesky_small(Q[..., n:, n:], reg)
    rhs = torch.cat([Q[..., n:, :n], q[..., n:, None]], -1)
    Kk = -cho_solve_small(chol, rhs)
    return Kk[..., :n], Kk[..., n]


def _associative_scan(fn, elems, reverse=False):
    """``jax.lax.associative_scan`` over axis 0 of a tuple of tensors, by its
    own recursion: combine adjacent pairs, scan the half-length result, then
    fill in the even positions, so that the same pairs combine in the same
    order."""
    if reverse:
        elems = tuple(torch.flip(e, [0]) for e in elems)

    def scan(elems):
        num = elems[0].shape[0]
        if num < 2:
            return elems
        reduced = fn(tuple(e[0 : num - 1 : 2] for e in elems), tuple(e[1::2] for e in elems))
        odd = scan(reduced)
        if num % 2 == 0:
            even = fn(tuple(o[:-1] for o in odd), tuple(e[2::2] for e in elems))
        else:
            even = fn(odd, tuple(e[2::2] for e in elems))
        even = tuple(torch.cat([e[:1], r]) for e, r in zip(elems, even))
        out = []
        for ev, od in zip(even, odd):
            both = ev.new_empty((ev.shape[0] + od.shape[0],) + tuple(ev.shape[1:]))
            both[0::2], both[1::2] = ev, od
            out.append(both)
        return tuple(out)

    scans = scan(elems)
    return tuple(torch.flip(s, [0]) for s in scans) if reverse else scans


def _reverse_scan(elems, init):
    """``lax.scan(step, init, elems, reverse=True)`` with
    ``step(carry, e) = (_combine(e, carry),) * 2``: the suffix compositions
    along axis 0 and the final carry."""
    carry, outs = init, [None] * elems[0].shape[0]
    for i in reversed(range(len(outs))):
        carry = _combine(tuple(e[i] for e in elems), carry)
        outs[i] = carry
    return carry, tuple(torch.stack(parts) for parts in zip(*outs))


def riccati_backward_assoc(
    C: torch.Tensor,
    c: torch.Tensor,
    F: torch.Tensor,
    f: Optional[torch.Tensor],
    n_state: int,
    *,
    reg: float = 1e-9,
) -> RiccatiResult:
    """The unconstrained Riccati backward pass with ``O(log T)`` time depth.
    ``C (T,B,nm,nm)``, ``c (T,B,nm)``, ``F (T,B,n,nm)``, ``f (T,B,n)`` or
    None; the gains in ``C.dtype``, ``free`` all true."""
    n = n_state
    T, B, m = C.shape[0], C.shape[1], C.shape[-1] - n
    if f is None:
        f = torch.zeros((T, B, n), dtype=C.dtype, device=C.device)
    elems = _build_elements(C, c, F, f, n, reg=reg)
    # comb[t] = e_t o e_t+1 o ... o e_T-1. The reverse scan hands its
    # combiner (later, earlier) in time, so the arguments are swapped.
    _, _, _, eta_c, J_c = _associative_scan(lambda a, b: _combine(b, a), elems, reverse=True)
    V_next = torch.cat([J_c[1:], torch.zeros_like(J_c[:1])])
    v_next = torch.cat([-eta_c[1:], torch.zeros_like(eta_c[:1])])
    K, k = _gains_from_value(C, c, F, f, V_next, v_next, n, reg)
    return RiccatiResult(K, k, torch.ones((T, B, m), dtype=torch.bool, device=C.device),
                         torch.zeros((T, B), dtype=torch.int32, device=C.device))


def riccati_backward_blocked(
    C: torch.Tensor,
    c: torch.Tensor,
    F: torch.Tensor,
    f: Optional[torch.Tensor],
    n_state: int,
    *,
    n_blocks: int,
    reg: float = 1e-9,
) -> RiccatiResult:
    """The blocked parallel-in-time Riccati on one device: the horizon cut
    into ``n_blocks`` blocks of ``L = T / n_blocks`` steps, each block
    suffix-composed with the blocks as a batch dimension, the block totals
    suffix-composed, and one batched boundary combine. Sequential depth
    ``T/D + D``. The contract of :func:`riccati_backward_assoc`; ``T`` must be
    divisible by ``n_blocks``."""
    n = n_state
    T, B, m = C.shape[0], C.shape[1], C.shape[-1] - n
    if f is None:
        f = torch.zeros((T, B, n), dtype=C.dtype, device=C.device)
    D = n_blocks
    if T % D != 0:
        raise ValueError(f"T={T} must be divisible by n_blocks={D}")
    L = T // D
    dtype, device = C.dtype, C.device

    elems = _build_elements(C, c, F, f, n, reg=reg)
    # (T, B, ...) -> (L, D, B, ...): block i owns t in [i L, (i+1) L)
    blk = tuple(e.reshape(D, L, *e.shape[1:]).swapaxes(0, 1) for e in elems)
    # 1. each block's suffix compositions, all D blocks as one batch:
    #    seq[l, i] = e_iL+l o ... o e_(i+1)L-1
    total, seq = _reverse_scan(blk, _identity_element((D, B), n, dtype, device))
    # 2. suffix-compose the D block totals (the only depth-D part)
    ident = _identity_element(B, n, dtype, device)
    _, rights = _reverse_scan(total, ident)
    rights_excl = tuple(torch.cat([r[1:], i[None]]) for r, i in zip(rights, ident))
    # 3. one batched boundary combine: glob[l, i] = seq[l, i] o (blocks i+1 ..)
    glob = _combine(seq, tuple(r[None].expand((L,) + r.shape) for r in rights_excl))
    _, _, _, eta_g, J_g = glob
    _, _, _, eta_r, J_r = rights_excl
    # V_t+1 per (l, i): the block's next step, or the next block's boundary
    V_next = torch.cat([J_g[1:], J_r[None]]).swapaxes(0, 1).reshape(T, B, n, n)
    v_next = torch.cat([-eta_g[1:], -eta_r[None]]).swapaxes(0, 1).reshape(T, B, n)
    K, k = _gains_from_value(C, c, F, f, V_next, v_next, n, reg)
    return RiccatiResult(K, k, torch.ones((T, B, m), dtype=torch.bool, device=device),
                         torch.zeros((T, B), dtype=torch.int32, device=device))


def riccati_backward_time_sharded(
    mesh,
    C: torch.Tensor,
    c: torch.Tensor,
    F: torch.Tensor,
    f: Optional[torch.Tensor],
    n_state: int,
    *,
    reg: float = 1e-9,
    time_axis: str = "time",
) -> RiccatiResult:
    """The horizon-sharded parallel-in-time Riccati: the blocks of
    :func:`riccati_backward_blocked` over the ranks of ``mesh``
    (:func:`~diffmpc_tpu_torch.parallel.make_mesh` with ``axis=time_axis``),
    rank ``r`` owning the ``r``-th block of the horizon.

    ``C, c, F, f`` are this rank's time slice, ``(L, B, ...)``: the horizon's
    shard on dim 0 (:func:`~diffmpc_tpu_torch.parallel.shard_batch` of the
    whole problem, which raises when ``T`` does not divide over the ranks).
    Every rank

    1. suffix-composes its own block's elements (the terminal zeroing only on
       rank ``D - 1``, which holds the last step),
    2. ``all_gather``s the ``D`` block totals (one ``(B, n, n)``-sized element
       a rank), suffix-composes them and takes its right neighbour's,
    3. combines each local suffix with it in one batched combine, and
       recovers its steps' gains.

    Sequential depth ``T/D + D``. Unconstrained only, like
    :func:`riccati_backward_assoc`. Returns this rank's time slice of the
    gains, ``K (L, B, m, n)`` and ``k (L, B, m)``."""
    if mesh.axis != time_axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}; the horizon shards over {time_axis!r}")
    n = n_state
    L, B, m = C.shape[0], C.shape[1], C.shape[-1] - n
    D, rank = mesh.size, mesh.rank
    dtype, device = C.dtype, C.device
    if f is None:
        f = torch.zeros((L, B, n), dtype=dtype, device=device)

    # 1. the local suffix compositions: seq[t] = e_t o ... o e_(block's last)
    elems = _build_elements(C, c, F, f, n, reg=reg, zero_last=rank == D - 1)
    ident = _identity_element(B, n, dtype, device)
    total, seq = _reverse_scan(elems, ident)
    # 2. every rank's block total, packed into one all_gather
    flat = torch.cat([e.reshape(B, -1) for e in total], -1)
    parts = [torch.empty_like(flat) for _ in range(D)]
    dist.all_gather(parts, flat, group=mesh.group)
    sizes = [e[0].numel() for e in total]
    totals = tuple(
        torch.stack([p.split(sizes, -1)[j] for p in parts]).reshape((D,) + total[j].shape) for j in range(5)
    )
    # rights[i] = totals[i] o ... o totals[D-1]; this rank's right neighbour's
    _, rights = _reverse_scan(totals, ident)
    my_right = tuple(r[rank + 1] if rank + 1 < D else i for r, i in zip(rights, ident))
    # 3. the global suffix of every local step in one batched combine
    glob = _combine(seq, tuple(r[None].expand((L,) + r.shape) for r in my_right))
    _, _, _, eta_g, J_g = glob
    _, _, _, eta_r, J_r = my_right
    V_next = torch.cat([J_g[1:], J_r[None]])
    v_next = torch.cat([-eta_g[1:], -eta_r[None]])
    K, k = _gains_from_value(C, c, F, f, V_next, v_next, n, reg)
    return RiccatiResult(K, k, torch.ones((L, B, m), dtype=torch.bool, device=device),
                         torch.zeros((L, B), dtype=torch.int32, device=device))
