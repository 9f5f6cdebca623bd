"""The CUDA kernels' per-scenario math, built for the host, against the
plain PyTorch versions, and each streaming twin against its resident
sibling.

``csrc/*.cuh`` holds the kernels' math as ``__host__ __device__`` functions.
Here g++ builds a small host shim over those headers (no torch headers, no
CUDA), and the port's own staging code (``run_staged`` / ``run_staged_kkt``
/ ``run_staged_riccati`` / ``run_staged_rollout``: batch-minor layout, the
argument structs, pointers) drives it on CPU tensors. Nothing on the main
path uses this build: on the card, nvcc builds the same headers into the
kernels of ``csrc/*.cu``.

Tolerances: the iLQR solve at ``lqr_iter=1, eps=0`` within 1e-4 abs with
``n_iters`` equal, four iterations by the chaos rule of
tests/torch_parity.py; the KKT backward (one linear pass, no chaos) within
1e-5; the Riccati sweep's ``K, k`` within ``1e-5 * max(1, max|plain|)``
with ``free`` and ``n_qp`` equal; the rollout's ``xs, us, objs`` within 1e-5
relative with ``alpha`` and ``improved`` equal. The streaming twins
(``csrc/*_stream.cuh``: the same per-step functions read through slot
accessors, the slots filled by plain copies on the host) hold the same
tolerances against the plain versions and equal their resident siblings'
host builds bit for bit: the same g++ arithmetic in the same order. The
depth-blocked sweep (``csrc/riccati_blocked.cuh``) holds its ``K, k`` within
``1e-5 * max(1, max|plain|)``; the piece kernels (``csrc/riccati_pieces.cuh``)
their ``K, k`` within ``1e-4 * max(1, max|plain|)`` and the rollout's
objective within 1e-5 relative. The line search's lane groups
(``csrc/rollout.cuh``, every built L, its slices read from the arrays or
staged through the group's slots) equal one lane bit for bit, and so do the
Riccati sweep's (``csrc/riccati.cuh``: the resident kernel and the twin,
every built L, with a NaN input, a box-QP tie and the simplified value
update), and the box QP's candidates one by one fold to the enumeration's
point at m = 2 and 3. The box QP's projected-Newton loop, left once done
and at every L with its Armijo candidates shared, equals a copy of the
fixed-trip one-lane loop bit for bit; a line search on which no candidate
improves equals one lane at every L and holds the plain version. So do the KKT backward's (``csrc/kkt.cuh``: every
built L, K, k and p on chip and in device memory, the twin, one lane with
and without its prefetch, at (3, 1), (4, 2) and (6, 3) with either value
update; one lane within ``1e-4 * max(1, max|plain|)`` of the plain
version); its auxiliary gains equal the mask-mode Riccati sweep's bit for
bit, and a C and F shared by every scenario, read in place, give the
outputs of their staged copies. The kernel-under-the-mesh probe
(``csrc/shard_probe.cuh``) equals its plain version bit for bit. The MLP step (``csrc/nn_mlp.cuh``, every
activation) inside the solve and the line search holds the same limits; the
solve's HoistLin pre-pass equals the solve without it bit for bit, the
MLP's and the pendulum's. A third unit builds the headers at what the card
builds as variants at first use (csrc/variants/): the (6, 3) MLP of
``DMPC_HIDDEN "16x16"`` in the fused solve with its box QP looping or
enumerating (one iteration within 1e-4, the objectives relative to their
scale), the pendulum's solve with the simplified value update, the Riccati
sweep under each box-QP mode that changes it at (6, 3) and (4, 2), the line
search at (6, 3), and the KKT pair at (6, 3) and (3, 1) with either value
update, each lane count bit-equal to one lane. One scenario (B=1, the render
example's problem of each of the five envs) holds the same: one iteration
within 1e-4, every lane count bit-equal to one lane, cold and warm-started.
"""

import ctypes
import glob
import os
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diffmpc_tpu_torch.csrc import build  # noqa: E402
from diffmpc_tpu_torch.models import NNDynamics  # noqa: E402
from diffmpc_tpu_torch.models.dynamics import ACTIVATIONS  # noqa: E402
from diffmpc_tpu_torch.ops.cuda import ilqr as ilqr_mod  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.ilqr import (  # noqa: E402
    ILQR_LANES,
    _IlqrArgs,
    _NNEnv,
    _PendulumEnv,
    ilqr_solve_plain,
    run_staged,
    run_staged_f32,
)
from diffmpc_tpu_torch.ops.cuda.kkt import (  # noqa: E402
    KKT_LANES,
    _KktArgs,
    kkt_backward_plain,
    reads_in_place,
    run_staged_kkt,
    stage_kkt,
)
from diffmpc_tpu_torch.ops.cuda.riccati import (  # noqa: E402
    RICCATI_LANES,
    _RiccatiArgs,
    riccati_backward_plain,
    run_staged_riccati,
)
from diffmpc_tpu_torch.ops.cuda.riccati_blocked import (  # noqa: E402
    _BlockedArgs,
    riccati_backward_blocked_plain,
    run_staged_blocked,
)
from diffmpc_tpu_torch.ops.cuda.riccati_pieces import PIECE_LANES  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.riccati_pieces import VARIANTS as PIECE_VARIANTS  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.riccati_pieces import (  # noqa: E402
    _PieceArgs,
    rollout_piece_plain,
    run_staged_pieces,
    sweep_piece_plain,
)
from diffmpc_tpu_torch.ops.cuda import rollout as rol_mod  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.rollout import (  # noqa: E402
    ROLLOUT_LANES,
    _RolloutArgs,
    linesearch_rollout_plain,
    run_staged_rollout,
)
from diffmpc_tpu_torch.ops.cuda.shard_probe import shard_probe_plain  # noqa: E402
from diffmpc_tpu_torch.ops.linearize import linearize_dynamics  # noqa: E402
from diffmpc_tpu_torch.ops.lqr import lqr_rollout  # noqa: E402
from diffmpc_tpu_torch.utils.batch import bmv  # noqa: E402
from oracles import random_lqr_problem  # noqa: E402
from torch_zoo_cases import ZOO, kernel_problem, one_robot_problem, port_model  # noqa: E402
from torch_parity import (  # noqa: E402
    as_numpy,
    assert_chaos,
    assert_tight,
    kernel_inputs,
    make_problem,
    random_residuals,
    torch_inputs,
)

SHIM = r"""
#include <vector>

#include "dual.cuh"
#include "ilqr.cuh"
#include "nn_mlp.cuh"
#include "pendulum.cuh"
#include "riccati.cuh"
#include "riccati_blocked.cuh"
#include "riccati_pieces.cuh"
#include "rollout.cuh"
#include "shard_probe.cuh"

// the fused solve by groups of L lanes, the lanes of each group one after
// another (HostLanes), at the lane counts the card's kernels are built for
template <class Env, bool HOIST, int L>
static int ilqr_group(const IlqrArgs* a, const Env* env) {
  if (!ilqr_lane_scratch_ok<Env, L>(*a)) return 1;
  std::vector<float> slots(ilqr_group_slot_floats<Env::N, Env::M>());
  const HostLanes<L> g{slots.data()};
  for (int b = 0; b < a->B; ++b) ilqr_solve_scenario<Env::N, Env::M, HOIST>(*a, *env, b, g);
  return 0;
}

template <class Env, bool HOIST>
static int ilqr_all(const IlqrArgs* a, const Env* env) {
  switch (a->lanes) {
#define HOST_LANE_CASE(_, L_) \
  case L_:                    \
    return ilqr_group<Env, HOIST, L_>(a, env);
    DMPC_LANES(HOST_LANE_CASE, _)
#undef HOST_LANE_CASE
  }
  return 1;
}

extern "C" int diffmpc_ilqr_solve_pendulum_host(const IlqrArgs* a, const PendulumEnv* env) {
  return ilqr_all<PendulumEnv, false>(a, env);
}

extern "C" int diffmpc_ilqr_solve_pendulum_hoist_host(const IlqrArgs* a, const PendulumEnv* env) {
  return ilqr_all<PendulumEnv, true>(a, env);
}

// the line search by groups of L lanes (HostLanes), its slices read from the
// arrays or (STREAM) staged through the group's slots; a launch whose lanes'
// trajectory scratch disagrees with rollout_keeps_lanes is refused
template <int N, int M, bool STREAM, class Env, int L>
static int rollout_group(const RolloutArgs* a, const Env& env) {
  if (!rollout_lane_scratch_ok<L>(*a)) return 1;
  std::vector<float> slots(rollout_group_slot_floats<N, M, Env, L>());
  const HostLanes<L> g{slots.data()};
  for (int b = 0; b < a->B; ++b) linesearch_rollout_scenario<N, M, STREAM>(*a, env, b, a->params, g);
  return 0;
}

template <int N, int M, bool STREAM, class Env>
static int rollout_all(const RolloutArgs* a, const Env& env) {
  switch (a->lanes) {
#define HOST_ROLLOUT_LANE_CASE(_, L_) \
  case L_:                            \
    return rollout_group<N, M, STREAM, Env, L_>(a, env);
    DMPC_LANES(HOST_ROLLOUT_LANE_CASE, _)
#undef HOST_ROLLOUT_LANE_CASE
  }
  return 1;
}

// the MLPs of the tests (nn_archs.cuh has the kernels' table): the solve with
// and without the HoistLin pre-pass, and the line search and its twin
#define DMPC_HOST_NN(N_, M_, NAME, ...)                                                              \
  using Env_##NAME = NNEnv<N_, M_, __VA_ARGS__>;                                                    \
  extern "C" int diffmpc_ilqr_solve_nn_##NAME##_host(const IlqrArgs* a, const Env_##NAME* env) {    \
    return ilqr_all<Env_##NAME, false>(a, env);                                                     \
  }                                                                                                 \
  extern "C" int diffmpc_ilqr_solve_nn_##NAME##_hoist_host(const IlqrArgs* a, const Env_##NAME* env) { \
    return ilqr_all<Env_##NAME, true>(a, env);                                                      \
  }                                                                                                 \
  extern "C" int diffmpc_rollout_nn_##NAME##_host(const RolloutArgs* a, const Env_##NAME* env, int stream) { \
    return stream ? rollout_all<N_, M_, true>(a, *env) : rollout_all<N_, M_, false>(a, *env);      \
  }

DMPC_HOST_NN(3, 1, n3m1_h8, 8)
DMPC_HOST_NN(3, 2, n3m2_h8, 8)

template <int N, int M, bool STREAM>
static int rollout_shapes(const RolloutArgs* a, int n, int m, const PendulumEnv* env) {
  if (env) return (n == 3 && m == 1) ? rollout_all<3, 1, STREAM>(a, *env) : 1;
  if (n == 3 && m == 2) return rollout_all<3, 2, STREAM>(a, LinearEnv{});
  if (n == 4 && m == 2) return rollout_all<4, 2, STREAM>(a, LinearEnv{});
  return 1;
}

// the resident line search (its slices read from the arrays) and the twin
// (STREAM: staged through the group's slots)
extern "C" int diffmpc_rollout_host(const RolloutArgs* a, int n, int m, const PendulumEnv* env) {
  return rollout_shapes<0, 0, false>(a, n, m, env);
}

extern "C" int diffmpc_rollout_stream_host(const RolloutArgs* a, int n, int m, const PendulumEnv* env) {
  return rollout_shapes<0, 0, true>(a, n, m, env);
}

// the blocked sweep over (block, scenario) threads, CTA by CTA in the
// card's geometry (blocked_geometry for `sms` SMs, `max_threads`, the
// card's 227 KB of shared memory and at most `cap` scenarios a CTA), the
// threads of a CTA one after another, phase by phase in the kernel's order:
// phases 1-2 in every thread, phase 3's P links in order, the carry handed
// from block p + 1's thread to block p's, then phase 4. Returns 2 where the
// geometry is refused, 3 where it places a (block, scenario) on no thread or
// on two, 4 where a carry the card shuffles would leave its warp or come
// from another lane than `width` lanes up.
template <int N, int M, int D>
static int blocked_threads(RiccatiBlockedArgs* a, int sms, int max_threads, int cap) {
  const RiccatiArgs& r = a->ric;
  const int P = r.T / D, B = r.B;
  BlockedGeometry geo{};
  if (!blocked_geometry<N>(B, P, D, sms, max_threads, 113 * 1024, 227 * 1024, cap, geo)) return 2;
  struct Carry {
    float V[N][N], v[N];
  };
  const int nt = geo.threads;
  std::vector<float> smem((size_t)nt * blocked_column_floats<N>(D));
  std::vector<ValueElement<N>> top(nt);
  std::vector<Carry> cur(nt), bnd(nt);
  std::vector<int> sc(nt), bl(nt), seen((size_t)B * P, 0);
  std::vector<char> ok(nt);
  for (int cta = 0; (long)cta * geo.width < B; ++cta) {
    for (int tid = 0; tid < nt; ++tid) {
      bool valid = false;
      geo.place(tid, sc[tid], bl[tid], valid);
      const int b = cta * geo.width + sc[tid];
      ok[tid] = valid && b < B;
      if (!ok[tid]) continue;
      if (geo.thread_of(sc[tid], bl[tid]) != tid) return 3;
      seen[(size_t)b * P + bl[tid]] += 1;
      blocked_compose<N, M, D>(r, b, bl[tid], ElementColumn{smem.data() + tid, nt}, top[tid]);
      cur[tid] = Carry{};
    }
    for (int k = 0; k < P; ++k) {
      const int active = P - 1 - k;
      for (int tid = 0; tid < nt; ++tid)
        if (ok[tid] && bl[tid] == active) {
          bnd[tid] = cur[tid];
          apply_element<N>(top[tid], cur[tid].V, cur[tid].v);
        }
      for (int tid = 0; tid < nt; ++tid)
        if (ok[tid] && bl[tid] == active - 1) {
          const int src = geo.thread_of(sc[tid], active);
          if (geo.shuffles() && (src / 32 != tid / 32 || src - tid != geo.width)) return 4;
          cur[tid] = cur[src];
        }
    }
    for (int tid = 0; tid < nt; ++tid)
      if (ok[tid])
        blocked_gains<N, M, D>(r, cta * geo.width + sc[tid], bl[tid], ElementColumn{smem.data() + tid, nt},
                               blocked_last_inputs<N, M, D>(r, cta * geo.width + sc[tid], bl[tid]), bnd[tid].V,
                               bnd[tid].v);
  }
  for (int c : seen)
    if (c != 1) return 3;
  return 0;
}

template <int N, int M>
static int blocked_all(RiccatiBlockedArgs* a, int sms, int max_threads, int cap) {
  if (a->block == 2) return blocked_threads<N, M, 2>(a, sms, max_threads, cap);
  return blocked_threads<N, M, 4>(a, sms, max_threads, cap);
}

extern "C" int diffmpc_riccati_blocked_host(RiccatiBlockedArgs* a, int n, int m, int sms, int max_threads, int cap) {
  if ((a->block != 2 && a->block != 4) || a->ric.T % a->block) return 1;
  if (n == 3 && m == 1) return blocked_all<3, 1>(a, sms, max_threads, cap);
  if (n == 3 && m == 2) return blocked_all<3, 2>(a, sms, max_threads, cap);
  if (n == 4 && m == 1) return blocked_all<4, 1>(a, sms, max_threads, cap);
  if (n == 4 && m == 2) return blocked_all<4, 2>(a, sms, max_threads, cap);
  return 1;
}

// the most blocks of a scenario one CTA holds (blocked_max_blocks) at
// `max_threads` threads and `smem_max` bytes of shared memory
extern "C" int diffmpc_riccati_blocked_max_blocks_host(int n, int m, int D, int max_threads, int smem_max) {
  (void)m;
  if (n == 3) return blocked_max_blocks<3>(D, max_threads, (size_t)smem_max);
  if (n == 4) return blocked_max_blocks<4>(D, max_threads, (size_t)smem_max);
  return -1;
}

// the piece sweep (VARIANT a PieceVariant) or the rollout (VARIANT -1) by
// groups of L lanes (HostLanes), staged through the group's ring or reading
// the arrays, at every DMPC_LANES count
template <int VARIANT, bool STAGED, int L>
static int pieces_group(const PieceArgs* a, const PendulumEnv* env) {
  std::vector<float> slots(piece_group_slot_floats());
  const HostLanes<L> g{slots.data()};
  for (int b = 0; b < a->B; ++b) {
    if constexpr (VARIANT < 0) piece_rollout_scenario<STAGED>(*a, *env, b, g);
    else piece_sweep_scenario<VARIANT, STAGED>(*a, *env, b, g);
  }
  return 0;
}

template <int VARIANT>
static int pieces_all(const PieceArgs* a, const PendulumEnv* env) {
  switch (a->lanes) {
#define HOST_PIECE_LANE_CASE(_, L_) \
  case L_:                          \
    return a->staged ? pieces_group<VARIANT, true, L_>(a, env) : pieces_group<VARIANT, false, L_>(a, env);
    DMPC_LANES(HOST_PIECE_LANE_CASE, _)
#undef HOST_PIECE_LANE_CASE
  }
  return 1;
}

// variant: a PieceVariant, or -1 for the rollout
extern "C" int diffmpc_riccati_pieces_host(const PieceArgs* a, const PendulumEnv* env, int variant) {
  switch (variant) {
    case kPieceFull: return pieces_all<kPieceFull>(a, env);
    case kPieceNoLin: return pieces_all<kPieceNoLin>(a, env);
    case kPieceNoQform: return pieces_all<kPieceNoQform>(a, env);
    case kPieceNoPnqp: return pieces_all<kPieceNoPnqp>(a, env);
    case kPieceNoVup: return pieces_all<kPieceNoVup>(a, env);
    case -1: return pieces_all<-1>(a, env);
  }
  return 1;
}

// the probe over the shard as a grid of `threads` threads runs it, the
// threads one after another (first = the thread's index, stride = threads)
extern "C" int diffmpc_shard_probe_host(const float* x, float* out, int L, int threads) {
  for (int first = 0; first < threads; ++first) shard_probe_fill(x, out, L, first, threads);
  return 0;
}

// dual.cuh's mixed operators with a constant, for B values a[b] with the
// tangents da[b][0..3] and the constant s[b]: a - s, s - a, s / a on
// Dual<float, 4> (values and tangents: vals[3 B], tans[3 B][4]) and on float
// and NcFloat (plain[3 B], nc[3 B])
extern "C" int diffmpc_dual_mixed_host(int B, const float* a, const float* da, const float* s, float* vals,
                                       float* tans, float* plain, float* nc) {
  for (int b = 0; b < B; ++b) {
    Dual<float, 4> x(a[b]);
    for (int i = 0; i < 4; ++i) x.d[i] = da[4 * b + i];
    const Dual<float, 4> r[3] = {x - s[b], s[b] - x, s[b] / x};
    const float f[3] = {a[b] - s[b], s[b] - a[b], s[b] / a[b]};
    const NcFloat y(a[b]);
    const NcFloat g[3] = {y - s[b], s[b] - y, s[b] / y};
    for (int k = 0; k < 3; ++k) {
      vals[3 * b + k] = r[k].v;
      for (int i = 0; i < 4; ++i) tans[4 * (3 * b + k) + i] = r[k].d[i];
      plain[3 * b + k] = f[k];
      nc[3 * b + k] = nc_out(g[k]);
    }
  }
  return 0;
}
"""


# The Riccati sweep by groups of L lanes (HostLanes), its slices read from
# the arrays or (STREAM, the twin) staged through the group's ring, at every
# DMPC_LANES count, with the box QP's enumeration mode ENUM.
HOST_RICCATI_GROUPS = r"""
template <int N, int M, int MODE, bool STREAM, int L, int ENUM = kPnqpEnumDefault>
static int riccati_group(const RiccatiArgs* a) {
  std::vector<float> slots(riccati_group_floats<N, M, MODE, STREAM, L, ENUM>() + 1);
  const HostLanes<L> g{slots.data()};
  for (int b = 0; b < a->B; ++b) riccati_sweep<N, M, MODE, STREAM, ENUM>(*a, g, b);
  return 0;
}

template <int N, int M, int MODE, bool STREAM, int ENUM = kPnqpEnumDefault>
static int riccati_lanes(const RiccatiArgs* a) {
  switch (a->lanes) {
#define HOST_RICCATI_LANE_CASE(_, L_) \
  case L_:                            \
    return riccati_group<N, M, MODE, STREAM, L_, ENUM>(a);
    DMPC_LANES(HOST_RICCATI_LANE_CASE, _)
#undef HOST_RICCATI_LANE_CASE
  }
  return 1;
}
"""


# The Riccati sweep's instantiations, compiled beside SHIM: by groups of L
# lanes (HostLanes), its slices read from the arrays or (STREAM, the twin)
# staged through the group's ring, at every DMPC_LANES count (the card's
# kernels take those of DMPC_RICCATI_LANES).
SHIM_RICCATI = r"""
#include <vector>

#include "riccati.cuh"
""" + HOST_RICCATI_GROUPS + r"""
template <int N, int M, bool STREAM>
static int riccati_modes(const RiccatiArgs* a, int mode) {
  if (mode == kRiccatiBox) return riccati_lanes<N, M, kRiccatiBox, STREAM>(a);
  if (mode == kRiccatiMask) return riccati_lanes<N, M, kRiccatiMask, STREAM>(a);
  return riccati_lanes<N, M, kRiccatiFree, STREAM>(a);
}

extern "C" int diffmpc_riccati_host(const RiccatiArgs* a, int n, int m, int mode) {
  if (n == 3 && m == 1) return riccati_modes<3, 1, false>(a, mode);
  if (n == 3 && m == 2) return riccati_modes<3, 2, false>(a, mode);
  if (n == 4 && m == 2) return riccati_modes<4, 2, false>(a, mode);
  if (n == 3 && m == 3 && mode == kRiccatiBox) return riccati_lanes<3, 3, kRiccatiBox, false>(a);
  return 1;
}

extern "C" int diffmpc_riccati_stream_host(const RiccatiArgs* a, int n, int m, int mode) {
  if (n == 3 && m == 1) return riccati_modes<3, 1, true>(a, mode);
  if (n == 3 && m == 2) return riccati_modes<3, 2, true>(a, mode);
  if (n == 4 && m == 2) return riccati_modes<4, 2, true>(a, mode);
  return 1;
}

// the box QP's enumeration of M dims for each of B QPs (row-major Quu, qu,
// lo, hi): serial (pnqp_enum_entries) and as its 3^M candidates one by one
// (pnqp_enum_candidate), folded in candidate order as the lane groups fold
template <int M>
static void enum_both(const float* Quu, const float* qu, const float* lo, const float* hi, float reg, float* serial,
                      float* split) {
  float Q[M][M], q[M], l[M], h[M], x[M], best[M];
  for (int i = 0; i < M; ++i) {
    for (int j = 0; j < M; ++j) Q[i][j] = Quu[i * M + j];
    q[i] = qu[i];
    l[i] = lo[i];
    h[i] = hi[i];
  }
  pnqp_enum_entries<M>(Q, q, l, h, reg, x);
  float best_obj = pnqp_enum_candidate<M>(0, Q, q, l, h, reg, best);
  constexpr int kCandidates = M == 2 ? 9 : 27;
  for (int c = 1; c < kCandidates; ++c) {
    float xc[M];
    const float o = pnqp_enum_candidate<M>(c, Q, q, l, h, reg, xc);
    if (o < best_obj) {
      for (int i = 0; i < M; ++i) best[i] = xc[i];
      best_obj = o;
    }
  }
  for (int i = 0; i < M; ++i) {
    serial[i] = x[i];
    split[i] = best[i];
  }
}

// The projected-Newton loop as the one-lane sweep ran it before it left
// the loop early: a fixed trip count of n_iter, the QP frozen once done, the
// Armijo steps by repeated halving; kept here as the reference of the loop
// the kernels run now (pnqp_loop_lanes; pnqp_entries runs it over one lane).
template <int M>
static float pnqp_loop_fixed_trip(const float (&Quu)[M][M], const float (&qu)[M], const float (&lo)[M],
                                  const float (&hi)[M], int n_iter, float reg, float (&x)[M]) {
  clipped_newton<M>(Quu, qu, lo, hi, reg, x);
  float done = 0.0f, n_qp = 0.0f;
  for (int it = 0; it < n_iter; ++it) {
    float frozen[M], rhs[1][M], dx[1][M];
    qp_frozen<M>(Quu, qu, lo, hi, x, frozen);
    for (int i = 0; i < M; ++i) {
      float g = 0.0f;
      for (int j = 0; j < M; ++j) g += Quu[i][j] * x[j];
      rhs[0][i] = -(g + qu[i]);
    }
    masked_chol_solve<M, 1>(Quu, rhs, frozen, reg, dx);
    float slack = 0.0f;
    for (int i = 0; i < M; ++i) slack += fmaxf(fabsf(dx[0][i]) - 1e-6f, 0.0f);
    const float step_small = slack == 0.0f ? 1.0f : 0.0f;
    const float f0 = qp_obj<M>(Quu, qu, x);
    float best[M], accepted = 0.0f, alpha = 1.0f;
    for (int i = 0; i < M; ++i) best[i] = x[i];
    for (int a = 0; a < 6; ++a) {
      float cand[M];
      for (int i = 0; i < M; ++i) cand[i] = clipf(x[i] + alpha * dx[0][i], lo[i], hi[i]);
      if (qp_obj<M>(Quu, qu, cand) < f0 && accepted == 0.0f) {
        for (int i = 0; i < M; ++i) best[i] = cand[i];
        accepted = 1.0f;
      }
      alpha *= 0.5f;
    }
    if (!(done > 0.0f))
      for (int i = 0; i < M; ++i) x[i] = best[i];
    n_qp = n_qp + (1.0f - done);
    done = fmaxf(done, fmaxf(step_small, 1.0f - accepted));
  }
  return n_qp;
}

// B box QPs of M dims (row-major Quu, qu, lo, hi) by the loop of `which`:
// -1 the fixed-trip reference, 0 the one-thread QP (pnqp_entries under the
// mode "0"), L > 0 a group of L lanes
// (HostLanes); each QP's point, frozen mask and step count
template <int M>
static int pnqp_loop_each(int which, int B, const float* Quu, const float* qu, const float* lo, const float* hi,
                          int n_iter, float reg, float* x_out, float* frozen_out, float* n_qp_out) {
  for (int b = 0; b < B; ++b) {
    float Q[M][M], q[M], l[M], h[M], x[M], frozen[M];
    for (int i = 0; i < M; ++i) {
      for (int j = 0; j < M; ++j) Q[i][j] = Quu[(b * M + i) * M + j];
      q[i] = qu[b * M + i];
      l[i] = lo[b * M + i];
      h[i] = hi[b * M + i];
    }
    float n_qp = 0.0f;
    switch (which) {
      case -1: n_qp = pnqp_loop_fixed_trip<M>(Q, q, l, h, n_iter, reg, x); break;
      case 0: {
        float frozen_entries[M];
        n_qp = pnqp_entries<M, false, kPnqpEnumLoop>(Q, q, l, h, n_iter, reg, x, frozen_entries);
        break;
      }
#define HOST_PNQP_LANE_CASE(_, L_)                                                          \
  case L_: {                                                                                \
    std::vector<float> slots(1);                                                            \
    n_qp = pnqp_loop_lanes<M>(HostLanes<L_>{slots.data()}, Q, q, l, h, n_iter, reg, x); \
    break;                                                                                  \
  }
      DMPC_LANES(HOST_PNQP_LANE_CASE, _)
#undef HOST_PNQP_LANE_CASE
      default: return 1;
    }
    qp_frozen<M>(Q, q, l, h, x, frozen);
    for (int i = 0; i < M; ++i) {
      x_out[b * M + i] = x[i];
      frozen_out[b * M + i] = frozen[i];
    }
    n_qp_out[b] = n_qp;
  }
  return 0;
}

extern "C" int diffmpc_pnqp_loop_host(int m, int which, int B, const float* Quu, const float* qu, const float* lo,
                                      const float* hi, int n_iter, float reg, float* x, float* frozen, float* n_qp) {
  if (m == 2) return pnqp_loop_each<2>(which, B, Quu, qu, lo, hi, n_iter, reg, x, frozen, n_qp);
  if (m == 3) return pnqp_loop_each<3>(which, B, Quu, qu, lo, hi, n_iter, reg, x, frozen, n_qp);
  return 1;
}

extern "C" int diffmpc_pnqp_enum_host(int m, int B, const float* Quu, const float* qu, const float* lo, const float* hi,
                                      float reg, float* serial, float* split) {
  if (m != 2 && m != 3) return 1;
  for (int b = 0; b < B; ++b) {
    const int o = b * m;
    if (m == 2) enum_both<2>(Quu + o * m, qu + o, lo + o, hi + o, reg, serial + o, split + o);
    else enum_both<3>(Quu + o * m, qu + o, lo + o, hi + o, reg, serial + o, split + o);
  }
  return 0;
}
"""


# The headers at what the card builds as variants (csrc/variants/), compiled
# beside SHIM: the (6, 3) MLP of 16-16 widths through variant.cuh's
# DMPC_HIDDEN (VariantNNEnv) in the fused solve, its box QP looping or
# enumerating its 27 active sets; the pendulum's solve with the simplified
# value update; the Riccati sweep at (6, 3) and (4, 2) under each mode that
# changes its QP; the line search at (6, 3); the KKT backward and twin at
# (6, 3) and (3, 1) with either value update.
SHIM_VARIANTS = r"""
#include <vector>

#define DMPC_N 6
#define DMPC_M 3
#define DMPC_HIDDEN "16x16"
#include "variants/variant.cuh"

#include "ilqr.cuh"
#include "pendulum.cuh"
#include "riccati.cuh"
#include "rollout.cuh"
""" + HOST_RICCATI_GROUPS + r"""
static_assert(VariantNNEnv::P == 9 * 16 + 16 + 16 * 16 + 16 + 16 * 6 + 6, "DMPC_HIDDEN parsed as 16, 16");

// the variants' fused solve, with the variant build's sweep (variant.cuh,
// kVariantSharedSweep), by groups of L lanes
template <class Env, int ENUM, bool EXACT, int L>
static int ilqr_variant_group(const IlqrArgs* a, const Env* env) {
  if (!ilqr_lane_scratch_ok<Env, L>(*a)) return 1;
  std::vector<float> slots(ilqr_group_floats<Env::N, Env::M, kVariantSharedSweep, L, ENUM>());
  const HostLanes<L> g{slots.data()};
  for (int b = 0; b < a->B; ++b)
    ilqr_solve_scenario<Env::N, Env::M, false, ENUM, EXACT, kVariantSharedSweep>(*a, *env, b, g);
  return 0;
}

// at every DMPC_LANES count
template <class Env, int ENUM, bool EXACT>
static int ilqr_variant(const IlqrArgs* a, const Env* env) {
  switch (a->lanes) {
#define HOST_VARIANT_LANE_CASE(_, L_) \
  case L_:                            \
    return ilqr_variant_group<Env, ENUM, EXACT, L_>(a, env);
    DMPC_LANES(HOST_VARIANT_LANE_CASE, _)
#undef HOST_VARIANT_LANE_CASE
  }
  return 1;
}

extern "C" int diffmpc_ilqr_solve_n6m3_h16x16_host(const IlqrArgs* a, const VariantNNEnv* env) {
  return ilqr_variant<VariantNNEnv, kPnqpEnumDefault, false>(a, env);
}
extern "C" int diffmpc_ilqr_solve_n6m3_h16x16_enum3_host(const IlqrArgs* a, const VariantNNEnv* env) {
  return ilqr_variant<VariantNNEnv, kPnqpEnumThree, false>(a, env);
}
extern "C" int diffmpc_ilqr_solve_pendulum_exact_host(const IlqrArgs* a, const PendulumEnv* env) {
  return ilqr_variant<PendulumEnv, kPnqpEnumDefault, true>(a, env);
}
// the pendulum as a variant with the default flags: the variant build's
// sweep beside the prebuilt kernel's (SHIM's diffmpc_ilqr_solve_pendulum_host)
extern "C" int diffmpc_ilqr_solve_pendulum_variant_host(const IlqrArgs* a, const PendulumEnv* env) {
  return ilqr_variant<PendulumEnv, kPnqpEnumDefault, false>(a, env);
}

// box mode: (6, 3) looping or (enum 2) enumerating, (4, 2) looping (enum 1);
// the twin for the (6, 3) enumeration
extern "C" int diffmpc_riccati_enum_host(const RiccatiArgs* a, int n, int m, int enum_, int stream) {
  if (n == 6 && m == 3 && enum_ == kPnqpEnumDefault && !stream)
    return riccati_lanes<6, 3, kRiccatiBox, false, kPnqpEnumDefault>(a);
  if (n == 6 && m == 3 && enum_ == kPnqpEnumThree)
    return stream ? riccati_lanes<6, 3, kRiccatiBox, true, kPnqpEnumThree>(a)
                  : riccati_lanes<6, 3, kRiccatiBox, false, kPnqpEnumThree>(a);
  if (n == 4 && m == 2 && enum_ == kPnqpEnumLoop && !stream)
    return riccati_lanes<4, 2, kRiccatiBox, false, kPnqpEnumLoop>(a);
  return 1;
}

// the line search of linear dynamics at (6, 3), resident or staged (STREAM)
template <bool STREAM, int L>
static int rollout63_group(const RolloutArgs* a) {
  if (!rollout_lane_scratch_ok<L>(*a)) return 1;
  std::vector<float> slots(rollout_group_slot_floats<6, 3, LinearEnv, L>());
  const HostLanes<L> g{slots.data()};
  for (int b = 0; b < a->B; ++b) linesearch_rollout_scenario<6, 3, STREAM>(*a, LinearEnv{}, b, a->params, g);
  return 0;
}

extern "C" int diffmpc_rollout_n6m3_host(const RolloutArgs* a, int stream) {
  switch (a->lanes) {
#define HOST_ROLLOUT63_CASE(_, L_) \
  case L_:                         \
    return stream ? rollout63_group<true, L_>(a) : rollout63_group<false, L_>(a);
    DMPC_LANES(HOST_ROLLOUT63_CASE, _)
#undef HOST_ROLLOUT63_CASE
  }
  return 1;
}

// the mask mode at (6, 3): the KKT backward's auxiliary sweep
extern "C" int diffmpc_riccati_mask63_host(const RiccatiArgs* a) {
  return riccati_lanes<6, 3, kRiccatiMask, false>(a);
}
"""


# The KKT backward by groups of L lanes (HostLanes), at every DMPC_LANES
# count: the resident kernel (K, k and p on chip unless the args say
# otherwise) and the twin (in device memory), each step's slice loaded while
# the step before computes (one lane: unless the args say otherwise),
# compiled beside SHIM at the
# table's shapes, (1, 1) and (6, 3), and with the simplified value update at
# (3, 1), (4, 2) and (6, 3).
SHIM_KKT = r"""
#include <vector>

#include "kkt.cuh"

template <int N, int M, bool EXACT, bool OnChip, int L, bool Prefetch = true>
static int kkt_group(const KktArgs* a) {
  std::vector<float> slots(kkt_group_floats<N, M, L, OnChip>(a->T) + 1);
  const HostLanes<L> g{slots.data()};
  for (int b = 0; b < a->B; ++b) kkt_backward_group<N, M, EXACT, OnChip, Prefetch>(*a, g, b);
  return 0;
}

template <int N, int M, bool EXACT, bool OnChip>
static int kkt_lanes(const KktArgs* a) {
  if (a->lanes == 1 && a->prefetch == 0) return kkt_group<N, M, EXACT, OnChip, 1, false>(a);
  switch (a->lanes) {
#define HOST_KKT_LANE_CASE(_, L_) \
  case L_:                        \
    return kkt_group<N, M, EXACT, OnChip, L_>(a);
    DMPC_LANES(HOST_KKT_LANE_CASE, _)
#undef HOST_KKT_LANE_CASE
  }
  return 1;
}

// the resident kernel keeps K, k, p on chip unless args->on_chip is 0; the
// twin never does
template <int N, int M, bool EXACT = false>
static int kkt_host(const KktArgs* a, int twin) {
  return !twin && a->on_chip != 0 ? kkt_lanes<N, M, EXACT, true>(a) : kkt_lanes<N, M, EXACT, false>(a);
}

static int kkt_shapes(const KktArgs* a, int n, int m, int twin) {
  if (n == 3 && m == 1) return kkt_host<3, 1>(a, twin);
  if (n == 3 && m == 2) return kkt_host<3, 2>(a, twin);
  if (n == 4 && m == 1) return kkt_host<4, 1>(a, twin);
  if (n == 4 && m == 2) return kkt_host<4, 2>(a, twin);
  if (n == 1 && m == 1) return kkt_host<1, 1>(a, twin);
  if (n == 6 && m == 3) return kkt_host<6, 3>(a, twin);
  return 1;
}

extern "C" int diffmpc_kkt_backward_host(const KktArgs* a, int n, int m) { return kkt_shapes(a, n, m, 0); }
extern "C" int diffmpc_kkt_backward_stream_host(const KktArgs* a, int n, int m) { return kkt_shapes(a, n, m, 1); }

// either value update at (3, 1), (4, 2) and (6, 3)
extern "C" int diffmpc_kkt_variant_host(const KktArgs* a, int n, int m, int exact, int stream) {
  if (!exact) return kkt_shapes(a, n, m, stream);
  if (n == 3 && m == 1) return kkt_host<3, 1, true>(a, stream);
  if (n == 4 && m == 2) return kkt_host<4, 2, true>(a, stream);
  if (n == 6 && m == 3) return kkt_host<6, 3, true>(a, stream);
  return 1;
}
"""


# The dynamics zoo's C++ steps (csrc/<env>.cuh) in the fused solve and the
# line search, each env a unit of its own compiled beside SHIM from the -D
# macros its variant is built from on the card (csrc/build.py's
# variant_defines: DMPC_ENV names the struct, DMPC_ENV_HEADER its header,
# read by variants/variant.cuh), plus ZOO_NAME for its symbols: the solve
# and the line search (its slices read from the arrays, or staged: the twin)
# at every DMPC_LANES count.
SHIM_ZOO = r"""
#include <vector>

#include "variants/variant.cuh"

#include "ilqr.cuh"
#include "rollout.cuh"

#define ZOO_CAT2(a, b) a##b
#define ZOO_CAT(a, b) ZOO_CAT2(a, b)
using Env = VariantCppEnv;

template <int L>
static int zoo_ilqr_group(const IlqrArgs* a, const Env* env) {
  if (!ilqr_lane_scratch_ok<Env, L>(*a)) return 1;
  std::vector<float> slots(ilqr_group_floats<Env::N, Env::M, kVariantSharedSweep, L>());
  const HostLanes<L> g{slots.data()};
  for (int b = 0; b < a->B; ++b)
    ilqr_solve_scenario<Env::N, Env::M, false, kPnqpEnumDefault, false, kVariantSharedSweep>(*a, *env, b, g);
  return 0;
}

template <bool STREAM, int L>
static int zoo_rollout_group(const RolloutArgs* a, const Env* env) {
  if (!rollout_lane_scratch_ok<L>(*a)) return 1;
  std::vector<float> slots(rollout_group_slot_floats<Env::N, Env::M, Env, L>());
  const HostLanes<L> g{slots.data()};
  for (int b = 0; b < a->B; ++b) linesearch_rollout_scenario<Env::N, Env::M, STREAM>(*a, *env, b, a->params, g);
  return 0;
}

extern "C" int ZOO_CAT(diffmpc_ilqr_solve_host_, ZOO_NAME)(const IlqrArgs* a, const Env* env) {
  switch (a->lanes) {
#define HOST_ZOO_LANE_CASE(_, L_) \
  case L_:                        \
    return zoo_ilqr_group<L_>(a, env);
    DMPC_LANES(HOST_ZOO_LANE_CASE, _)
#undef HOST_ZOO_LANE_CASE
  }
  return 1;
}

extern "C" int ZOO_CAT(diffmpc_rollout_host_, ZOO_NAME)(const RolloutArgs* a, const Env* env, int stream) {
  switch (a->lanes) {
#define HOST_ZOO_ROLLOUT_CASE(_, L_) \
  case L_:                           \
    return stream ? zoo_rollout_group<true, L_>(a, env) : zoo_rollout_group<false, L_>(a, env);
    DMPC_LANES(HOST_ZOO_ROLLOUT_CASE, _)
#undef HOST_ZOO_ROLLOUT_CASE
  }
  return 1;
}
"""

ZOO_KEYS = {"cartpole": (5, 1), "vehicle": (4, 2), "quadrotor": (6, 2), "acrobot": (6, 1)}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of the kernel headers needs it")
    d = tmp_path_factory.mktemp("kernel_host")
    so = d / "libshim.so"
    flags = [gxx, "-O2", "-std=c++17", "-fPIC", "-I", build.CSRC]
    procs = []
    units = (("shim", SHIM), ("shim_riccati", SHIM_RICCATI), ("shim_variants", SHIM_VARIANTS), ("shim_kkt", SHIM_KKT))
    for name, text in units:
        (d / f"{name}.cpp").write_text(text)
        procs.append(subprocess.Popen([*flags, "-c", "-o", str(d / f"{name}.o"), str(d / f"{name}.cpp")],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    (d / "shim_zoo.cpp").write_text(SHIM_ZOO)
    zoo_units = []
    for env, (n, m), flip in [(env, nm, "") for env, nm in ZOO_KEYS.items()] + [("acrobot", (6, 1), "_flipped")]:
        defines = [*build.variant_defines(build.VariantKey("ilqr", n, m, env)), f"-DZOO_NAME={env}{flip}"]
        if flip:  # the cheap-step A/B's other build (diagnostics/ab_cheap_step.py)
            defines.append("-DDMPC_FLIP_CHEAP_STEP=1")
        zoo_units.append(f"shim_zoo_{env}{flip}")
        procs.append(subprocess.Popen([*flags, *defines, "-c", "-o", str(d / f"{zoo_units[-1]}.o"),
                                       str(d / "shim_zoo.cpp")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    for proc in procs:
        _, err = proc.communicate()
        assert proc.returncode == 0, err
    objs = [str(d / f"{name}.o") for name, _ in units] + [str(d / f"{name}.o") for name in zoo_units]
    proc = subprocess.run([*flags, "-shared", "-o", str(so), *objs], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def host_launch(host_lib):
    return _ilqr_launcher(host_lib, "diffmpc_ilqr_solve_pendulum_host", _PendulumEnv)


def _ilqr_launcher(host_lib, symbol, struct):
    """The host build's fused solve ``symbol`` for env ``struct``, its
    scenarios each solved by a group of the args' lane count (``run_staged``
    sets it)."""
    fn = getattr(host_lib, symbol)
    fn.argtypes = [ctypes.POINTER(_IlqrArgs), ctypes.POINTER(struct)]
    fn.restype = ctypes.c_int

    def launch(args, env):
        assert fn(args, env) == 0, "refused: a lane count that is not built, or lane scratch against the rule"

    return launch


def _solve_both(launch, prob, **knobs):
    t, dx = torch_inputs(prob)
    args = (t["x_init"], t["C"], t["c"], dx, t["u_lower"], t["u_upper"])
    host = run_staged(launch, *args, u_init=t["u_init"], **knobs)
    plain = ilqr_solve_plain(*args, u_init=t["u_init"], **knobs)
    return as_numpy(host), as_numpy(plain)


@pytest.mark.parametrize(
    "prob_kw,knobs",
    [
        (dict(), dict()),
        (dict(warm=True, batched_params=True), dict(delta_u=0.5)),
    ],
    ids=["cold", "all_knobs"],
)
def test_host_build_one_iteration_matches_plain(host_launch, prob_kw, knobs):
    host, plain = _solve_both(host_launch, make_problem(**prob_kw), lqr_iter=1, eps=0.0, **knobs)
    assert_tight(host, plain)


def test_host_build_four_iterations_match_plain(host_launch):
    prob = make_problem(seed=702, warm=True, batched_params=True)
    host, plain = _solve_both(host_launch, prob, lqr_iter=4, eps=1e-5, delta_u=0.5)
    assert_chaos(host, plain)
    assert host["converged"].dtype == bool and host["n_iters"].dtype == np.int32


def test_host_build_early_exit_keeps_frozen_scenarios(host_launch):
    """A scenario frozen early keeps its result however long the others
    run: solving it alone or inside a batch that needs more iterations
    gives the same answer (the per-thread early exit of the kernel)."""
    prob = make_problem(seed=703)
    full, _ = _solve_both(host_launch, prob, lqr_iter=6, eps=1e-3)
    # the first scenario alone: a batch of one reaches no other scenario
    one = {
        k: None if v is None else np.ascontiguousarray(v[:1] if k == "x_init" else v[:, :1])
        for k, v in prob.items() if k != "params"
    }
    one["params"] = prob["params"]
    alone, _ = _solve_both(host_launch, one, lqr_iter=6, eps=1e-3)
    for f in ("us", "xs"):
        np.testing.assert_array_equal(alone[f][:, 0], full[f][:, 0])
    assert alone["n_iters"][0] == full["n_iters"][0]


def test_host_build_float64_through_the_cast_helper(host_launch):
    """The kernel route's cast helper: float64 in, float64 out. The inputs
    hold float32 values, so the cast is exact and the result equals the
    float32 run within 1e-6; against the plain version on the same float64
    inputs, which computes in float64, the kernel-vs-plain bound of one
    iteration holds (1e-4: float32 rounding with the kernel's own sin/cos
    and summation order moves the states by a few 1e-6)."""
    t, dx = torch_inputs(make_problem(seed=705, warm=True, batched_params=True))
    t64 = {k: v.double() for k, v in t.items()}
    dx64 = dx.replace(params=dx.params.double())
    args = (t64["x_init"], t64["C"], t64["c"], dx64, t64["u_lower"], t64["u_upper"])
    knobs = dict(lqr_iter=1, eps=0.0)
    got = run_staged_f32(host_launch, *args, u_init=t64["u_init"], **knobs)
    f32 = run_staged(
        host_launch, t["x_init"], t["C"], t["c"], dx, t["u_lower"], t["u_upper"],
        u_init=t["u_init"], **knobs,
    )
    for f in ("xs", "us", "objs", "last_improvement", "alpha", "qp_iters"):
        g = getattr(got, f)
        assert g.dtype == torch.float64, f
        np.testing.assert_allclose(g.numpy(), getattr(f32, f).double().numpy(), atol=1e-6, rtol=0)
    assert got.n_iters.dtype == torch.int32 and got.converged.dtype == torch.bool
    plain = ilqr_solve_plain(*args, u_init=t64["u_init"], **knobs)
    assert plain.us.dtype == torch.float64
    assert_tight(as_numpy(got), as_numpy(plain))


def _kkt_launcher(host_lib, symbol):
    fn = getattr(host_lib, symbol)
    fn.argtypes = [ctypes.POINTER(_KktArgs), ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int

    def launch(args, n, m):
        assert fn(args, n, m) == 0, f"no host instantiation for n={n}, m={m}"

    return launch


@pytest.fixture(scope="module")
def host_kkt_launch(host_lib):
    return _kkt_launcher(host_lib, "diffmpc_kkt_backward_host")


@pytest.fixture(scope="module")
def host_kkt_stream_launch(host_lib):
    return _kkt_launcher(host_lib, "diffmpc_kkt_backward_stream_host")


@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("n,m,n_tight", [(3, 1, 12), (3, 2, 20), (1, 1, 6), (4, 1, 12), (4, 2, 20)])
def test_host_build_kkt_backward_matches_plain(host_kkt_launch, n, m, n_tight, B):
    rng = np.random.default_rng(820 + 10 * n + m + B)
    res = random_residuals(rng, 7, B, n, m, min(n_tight, 7 * B * m // 2))
    ins = [torch.tensor(a) for a in kernel_inputs(res)]
    got = run_staged_kkt(host_kkt_launch, *ins, reg=1e-7)
    want = kkt_backward_plain(*ins, reg=1e-7)
    for name, g, w in zip(("dx_init", "dC", "dc", "dF", "df"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=1e-5, err_msg=name)


def _riccati_launcher(host_lib, symbol):
    fn = getattr(host_lib, symbol)
    fn.argtypes = [ctypes.POINTER(_RiccatiArgs), ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int

    def launch(args, n, m, mode):
        assert fn(args, n, m, mode) == 0, f"no host instantiation for n={n}, m={m}, mode={mode}"

    return launch


@pytest.fixture(scope="module")
def host_riccati_launch(host_lib):
    return _riccati_launcher(host_lib, "diffmpc_riccati_host")


@pytest.fixture(scope="module")
def host_riccati_stream_launch(host_lib):
    return _riccati_launcher(host_lib, "diffmpc_riccati_stream_host")


@pytest.mark.parametrize(
    "n,m,mode",
    [(n, m, mode) for n, m in ((3, 1), (3, 2), (4, 2)) for mode in ("free", "box", "mask")]
    + [(3, 3, "box")],
)
def test_host_build_riccati_matches_plain(host_riccati_launch, n, m, mode):
    T, B = 6, 37
    rng = np.random.default_rng(850 + 10 * n + m)
    C, c, F, f, _ = (torch.tensor(a, dtype=torch.float32) for a in random_lqr_problem(rng, T, B, n, m))
    kw = {}
    if mode == "box":
        u_hat = torch.tensor(rng.uniform(-0.3, 0.3, (T, B, m)), dtype=torch.float32)
        kw = dict(u_lower=torch.tensor(-0.5), u_upper=torch.full((T, B, m), 0.5), u_hat=u_hat)
    elif mode == "mask":
        kw = dict(ctrl_mask=torch.tensor(rng.random((T, B, m)) < 0.3))
    got = run_staged_riccati(host_riccati_launch, C, c, F, f, n, **kw)
    want = riccati_backward_plain(C, c, F, f, n, **kw)
    for name in ("K", "k"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5 * max(1.0, float(w.abs().max())), rtol=0, err_msg=name)
    np.testing.assert_array_equal(got.free_mask.numpy(), want.free_mask.numpy())
    np.testing.assert_array_equal(got.n_qp_iter.numpy(), want.n_qp_iter.numpy())
    if mode == "box":
        assert not bool(got.free_mask.all())
        assert (m == 3) == bool((got.n_qp_iter > 1).any())  # only the m = 3 loop iterates


def _rollout_launcher(host_lib, symbol):
    fn = getattr(host_lib, symbol)
    fn.argtypes = [ctypes.POINTER(_RolloutArgs), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(args, n, m, env):
        assert fn(args, n, m, env) == 0, f"no host instantiation for n={n}, m={m}"

    return launch


@pytest.fixture(scope="module")
def host_rollout_launch(host_lib):
    return _rollout_launcher(host_lib, "diffmpc_rollout_host")


@pytest.fixture(scope="module")
def host_rollout_stream_launch(host_lib):
    return _rollout_launcher(host_lib, "diffmpc_rollout_stream_host")


def _assert_rollout_matches(got, want):
    for name in ("xs", "us", "objs"):
        g, w = getattr(got, name).numpy(), getattr(want, name).numpy()
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max(), err_msg=name)
    np.testing.assert_array_equal(got.alpha.numpy(), want.alpha.numpy())
    np.testing.assert_array_equal(got.improved.numpy(), want.improved.numpy())


@pytest.mark.parametrize("n,m,box,delta_u", [(3, 2, False, None), (4, 2, True, None), (4, 2, True, 0.8)])
def test_host_build_linear_rollout_matches_plain(host_rollout_launch, n, m, box, delta_u):
    T, B = 7, 37
    rng = np.random.default_rng(860 + 10 * n + m + box)
    C, c, F, f, x0 = (torch.tensor(a, dtype=torch.float32) for a in random_lqr_problem(rng, T, B, n, m))
    u_hat = torch.tensor(rng.uniform(-0.3, 0.3, (T, B, m)), dtype=torch.float32)
    x_hat, _ = lqr_rollout(x0, F, f, torch.zeros(T, B, m, n), torch.zeros(T, B, m), u_hat=u_hat)
    K = torch.tensor(rng.normal(size=(T, B, m, n)) * 0.3, dtype=torch.float32)
    k = torch.tensor(rng.normal(size=(T, B, m)), dtype=torch.float32)
    kw = dict(delta_u=delta_u, decay=0.5, max_iter=6)
    if box:
        kw.update(u_lower=torch.tensor(-0.7), u_upper=torch.full((T, B, m), 0.7))
    args = (x0, C, c, F, f, K, k, x_hat, u_hat)
    got = run_staged_rollout(host_rollout_launch, *args, **kw)
    want = linesearch_rollout_plain(*args, **kw)
    _assert_rollout_matches(got, want)
    assert len(np.unique(got.alpha.numpy())) > 1


def test_host_build_pendulum_rollout_matches_plain(host_rollout_launch):
    prob = make_problem(seed=870, batched_params=True, warm=True)
    t, dx = torch_inputs(prob)
    T, B = t["C"].shape[:2]
    rng = np.random.default_rng(871)
    x_hat = torch.tensor(rng.normal(size=(T, B, 3)), dtype=torch.float32)
    u_hat = t["u_init"].clamp(-2.0, 2.0)
    K = torch.tensor(rng.normal(size=(T, B, 1, 3)) * 0.5, dtype=torch.float32)
    k = torch.tensor(rng.normal(size=(T, B, 1)), dtype=torch.float32)
    args = (t["x_init"], t["C"], t["c"], None, None, K, k, x_hat, u_hat)
    kw = dict(u_lower=t["u_lower"], u_upper=t["u_upper"], dyn=dx, delta_u=1.0)
    got = run_staged_rollout(host_rollout_launch, *args, **kw)
    want = linesearch_rollout_plain(*args, **kw)
    _assert_rollout_matches(got, want)


# ---------------------------------------------------------------------------
# The streaming twins: the same staging, their own per-scenario loops.
# ---------------------------------------------------------------------------


def _assert_equal_results(got, want):
    for name, g, w in zip(getattr(want, "_fields", range(len(want))), got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=str(name))


@pytest.mark.parametrize("with_f", [False, True], ids=["f_none", "with_f"])
@pytest.mark.parametrize(
    "n,m,mode", [(n, m, mode) for n, m in ((3, 1), (3, 2), (4, 2)) for mode in ("free", "box", "mask")]
)
def test_host_build_riccati_twin_matches_plain_and_resident(
    host_riccati_launch, host_riccati_stream_launch, n, m, mode, with_f
):
    T, B = 9, 37
    rng = np.random.default_rng(950 + 10 * n + m)
    C, c, F, f, _ = (torch.tensor(a, dtype=torch.float32) for a in random_lqr_problem(rng, T, B, n, m))
    f = f if with_f else None
    kw = {}
    if mode == "box":
        u_hat = torch.tensor(rng.uniform(-0.3, 0.3, (T, B, m)), dtype=torch.float32)
        kw = dict(u_lower=torch.tensor(-0.5), u_upper=torch.full((T, B, m), 0.5), u_hat=u_hat)
    elif mode == "mask":
        kw = dict(ctrl_mask=torch.tensor(rng.random((T, B, m)) < 0.3))
    got = run_staged_riccati(host_riccati_stream_launch, C, c, F, f, n, **kw)
    want = riccati_backward_plain(C, c, F, f, n, **kw)
    for name in ("K", "k"):
        g, w = getattr(got, name), getattr(want, name)
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5 * max(1.0, float(w.abs().max())), rtol=0, err_msg=name)
    np.testing.assert_array_equal(got.free_mask.numpy(), want.free_mask.numpy())
    np.testing.assert_array_equal(got.n_qp_iter.numpy(), want.n_qp_iter.numpy())
    _assert_equal_results(got, run_staged_riccati(host_riccati_launch, C, c, F, f, n, **kw))


# ---------------------------------------------------------------------------
# The Riccati sweep by lane groups (riccati.cuh): every built L of the
# resident kernel and the twin against one lane.
# ---------------------------------------------------------------------------


def _riccati_lane_case(n, m, mode, with_f, seed, T=6, B=21):
    """``(args, kw)`` of a Riccati sweep: tests/oracles.py's random LQR
    problem, a box of +-0.5 about a random ``u_hat`` (box mode) or ~30% of
    the controls frozen (mask mode)."""
    rng = np.random.default_rng(seed)
    C, c, F, f, _ = (torch.tensor(a, dtype=torch.float32) for a in random_lqr_problem(rng, T, B, n, m))
    kw = {}
    if mode == "box":
        u_hat = torch.tensor(rng.uniform(-0.3, 0.3, (T, B, m)), dtype=torch.float32)
        kw = dict(u_lower=torch.tensor(-0.5), u_upper=torch.full((T, B, m), 0.5), u_hat=u_hat)
    elif mode == "mask":
        kw = dict(ctrl_mask=torch.tensor(rng.random((T, B, m)) < 0.3))
    return (C, c, F, f if with_f else None, n), kw


def _assert_riccati_matches(got, want):
    """The host build against the plain version: ``K, k`` within
    ``1e-5 * max(1, max|plain|)``, ``free`` and ``n_qp`` equal."""
    for name in ("K", "k"):
        g, w = getattr(got, name).numpy(), getattr(want, name).numpy()
        np.testing.assert_allclose(g, w, atol=1e-5 * max(1.0, float(np.nanmax(np.abs(w)))), rtol=0, err_msg=name)
    np.testing.assert_array_equal(got.free_mask.numpy(), want.free_mask.numpy())
    np.testing.assert_array_equal(got.n_qp_iter.numpy(), want.n_qp_iter.numpy())


def _riccati_every_lane_count(launches, args, kw, one):
    """Every lane count of the host build (``DMPC_LANES``: the card's
    ``RICCATI_LANES`` and 2 and 4, which do not divide every share evenly)
    of each launch equals ``one`` bit for bit."""
    assert set(RICCATI_LANES) <= set(ILQR_LANES)
    for launch in launches:
        for lanes in ILQR_LANES:
            _assert_equal_results(run_staged_riccati(launch, *args, lanes=lanes, **kw), one)


@pytest.mark.parametrize("with_f", [False, True], ids=["f_none", "with_f"])
@pytest.mark.parametrize(
    "n,m,mode", [(n, m, mode) for n, m in ((3, 1), (3, 2), (4, 2)) for mode in ("free", "box", "mask")]
)
def test_host_build_riccati_lanes_equal_one_lane(host_riccati_launch, host_riccati_stream_launch, n, m, mode, with_f):
    """The resident kernel and the twin at every built lane count (each
    step's entries of Q and q, the m = 2 QP's candidates, the gains' columns
    and the updated value's entries shared out over the lanes) equal the
    resident kernel at one lane bit for bit, which holds the plain version's
    rule."""
    args, kw = _riccati_lane_case(n, m, mode, with_f, 1500 + 10 * n + m)
    one = run_staged_riccati(host_riccati_launch, *args, **kw)
    _assert_riccati_matches(one, riccati_backward_plain(*args, **kw))
    if mode == "box":
        assert not bool(one.free_mask.all())
    _riccati_every_lane_count((host_riccati_launch, host_riccati_stream_launch), args, kw, one)


def test_host_build_riccati_lanes_keep_a_nan_to_its_scenario(host_riccati_launch, host_riccati_stream_launch):
    """A NaN in one step's C of one scenario: every L of both kernels equals
    one lane bit for bit, NaN positions included, which are the plain
    version's; the other scenarios equal the sweep without the NaN."""
    args, kw = _riccati_lane_case(4, 2, "box", True, 1560)
    clean = run_staged_riccati(host_riccati_launch, *args, **kw)
    C = args[0].clone()
    C[3, 5, 1, 4] = C[3, 5, 4, 1] = float("nan")
    args = (C,) + args[1:]
    one = run_staged_riccati(host_riccati_launch, *args, **kw)
    want = riccati_backward_plain(*args, **kw)
    assert bool(torch.isnan(one.K[:, 5]).any()) and not bool(torch.isnan(one.K[4:]).any())
    for name in ("K", "k"):
        np.testing.assert_array_equal(torch.isnan(getattr(one, name)).numpy(), torch.isnan(getattr(want, name)).numpy())
    others = torch.arange(one.K.shape[1]) != 5
    for g, w in zip(one, clean):
        np.testing.assert_array_equal(g[:, others].numpy(), w[:, others].numpy())
    _riccati_every_lane_count((host_riccati_launch, host_riccati_stream_launch), args, kw, one)


def _f32_qp_obj(Quu, qu, x):
    """qp_obj of csrc/riccati_entries.cuh in float32, operation by
    operation."""
    f = np.float32
    acc = f(0.0)
    for i in range(2):
        hx = f(0.0)
        for j in range(2):
            hx = f(hx + f(f(Quu[i][j]) * f(x[j])))
        acc = f(acc + f(f(f(f(0.5) * f(x[i])) * hx) + f(f(qu[i]) * f(x[i]))))
    return acc


def test_host_build_riccati_lanes_keep_the_earlier_of_tied_candidates(host_riccati_launch, host_riccati_stream_launch):
    """A box QP (T=1, so Quu and qu are C's and c's control blocks) on which
    the clipped Newton point (1, -1), candidate 0, and the enumeration's
    candidate 1 (dim 0 free at 63/64, dim 1 at its lower bound), both
    KKT-valid, tie in float32 objective: every L of both kernels keeps
    candidate 0, as the enumeration's strict "<" does, on every scenario."""
    n, m, T, B = 4, 2, 1, 5
    Quu, qu = [[4.0, 1.0], [1.0, 4.0]], [-2.9375, 16384.0]
    assert _f32_qp_obj(Quu, qu, (1.0, -1.0)) == _f32_qp_obj(Quu, qu, (63 / 64, -1.0))
    rng = np.random.default_rng(1570)
    C = np.zeros((T, B, n + m, n + m), np.float32)
    C[..., :n, :n] = np.eye(n, dtype=np.float32)
    C[..., n:, n:] = Quu
    c = np.zeros((T, B, n + m), np.float32)
    c[..., n:] = qu
    F = rng.normal(size=(T, B, n, n + m)).astype(np.float32)
    args = (torch.tensor(C), torch.tensor(c), torch.tensor(F), None, n)
    kw = dict(u_lower=torch.tensor(-1.0), u_upper=torch.tensor(1.0), u_hat=torch.zeros(T, B, m))
    one = run_staged_riccati(host_riccati_launch, *args, **kw)
    assert one.k.tolist() == [[[1.0, -1.0]] * B]
    _assert_equal_results(riccati_backward_plain(*args, **kw), one)
    _riccati_every_lane_count((host_riccati_launch, host_riccati_stream_launch), args, kw, one)


@pytest.mark.parametrize("m", [2, 3])
def test_host_build_box_qp_candidates_fold_to_the_enumeration(host_lib, m):
    """The 3^m candidates of the box QP's enumeration one by one
    (``pnqp_enum_candidate``, a run-time code: the lane groups' share, m = 2
    on the card, m = 3 the instantiation a later m = 3 kernel takes), folded
    in candidate order by a strict "<", give the serial enumeration's point
    bit for bit, on QPs whose optima sit inside, on faces and in corners."""
    rng = np.random.default_rng(1590 + m)
    B = 3000
    A = rng.normal(size=(B, m, m))
    Quu = (A @ A.transpose(0, 2, 1) / m + 0.05 * np.eye(m)).astype(np.float32)
    qu = (rng.normal(size=(B, m)) * rng.choice([0.1, 1.0, 10.0], size=(B, 1))).astype(np.float32)
    lo = -rng.uniform(0.05, 1.0, (B, m)).astype(np.float32)
    hi = rng.uniform(0.05, 1.0, (B, m)).astype(np.float32)
    serial, split = np.empty((B, m), np.float32), np.empty((B, m), np.float32)
    fn = host_lib.diffmpc_pnqp_enum_host
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    assert fn(m, B, *(a.ctypes.data for a in (Quu, qu, lo, hi)), 1e-9, serial.ctypes.data, split.ctypes.data) == 0
    np.testing.assert_array_equal(split, serial)
    at_bound = (serial <= lo + 1e-6) | (serial >= hi - 1e-6)
    assert 0.2 < at_bound.mean() < 0.9 and bool(at_bound.all(-1).any()) and bool((~at_bound).all(-1).any())


def _pnqp_loop(host_lib, m, which, QPs, n_iter):
    """Each box QP of ``QPs`` (Quu, qu, lo, hi, float32 arrays over B) by the
    host build's loop ``which`` (-1 the fixed-trip reference, 0 the one-lane
    loop, L a group of L lanes): ``(x, frozen, n_qp)``."""
    Quu, qu, lo, hi = (np.ascontiguousarray(a, np.float32) for a in QPs)
    B = qu.shape[0]
    x, frozen, n_qp = np.empty((B, m), np.float32), np.empty((B, m), np.float32), np.empty(B, np.float32)
    fn = host_lib.diffmpc_pnqp_loop_host
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    assert fn(m, which, B, *(a.ctypes.data for a in (Quu, qu, lo, hi)), n_iter, 1e-9, x.ctypes.data,
              frozen.ctypes.data, n_qp.ctypes.data) == 0
    return x, frozen, n_qp


def _pnqp_loop_cases(m, B, seed):
    """Box QPs of ``m`` dims: random ones (optima inside, on faces, in
    corners), ones whose unconstrained optimum lies inside the box (done at
    the first step), ill-conditioned ones with their optimum outside (the
    loop runs long), and one with a NaN in Quu."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, m, m))
    Quu = A @ A.transpose(0, 2, 1) / m + 0.05 * np.eye(m)
    qu = rng.normal(size=(B, m)) * rng.choice([0.1, 1.0, 10.0], size=(B, 1))
    lo, hi = -rng.uniform(0.05, 1.0, (B, m)), rng.uniform(0.05, 1.0, (B, m))
    inside = slice(0, B // 8)  # the optimum x* = 0.01 inside a box of +-1
    Quu[inside] = np.eye(m) * rng.uniform(1.0, 2.0, (B // 8, 1, 1))
    qu[inside] = -0.01 * np.einsum("bij,j->bi", Quu[inside], np.ones(m))
    lo[inside], hi[inside] = -1.0, 1.0
    stiff = slice(B // 8, B // 4)  # condition ~1e4, the optimum far outside
    V = np.linalg.qr(rng.normal(size=(B // 8, m, m)))[0]
    Quu[stiff] = V @ (np.eye(m) * np.geomspace(1e-4, 1.0, m)) @ V.transpose(0, 2, 1)
    qu[stiff] = rng.normal(size=(B // 8, m)) * 5.0
    Quu[B - 1, 0, 1] = Quu[B - 1, 1, 0] = np.nan
    return [a.astype(np.float32) for a in (Quu, qu, lo, hi)]


@pytest.mark.parametrize("n_iter", [8, 2])
@pytest.mark.parametrize("m", [2, 3])
def test_host_build_pnqp_loop_leaves_early_and_shares_its_ladder_bit_for_bit(host_lib, m, n_iter):
    """The box QP's projected-Newton loop (m = 3, and m = 2 under "0") that
    leaves once the QP is done, at one lane and with its Armijo candidates
    shared over a group of every built L (a ballot picks the first
    improving one), gives the fixed-trip one-lane loop's point, frozen mask
    and step count bit for bit: on QPs done at the first step, QPs that run
    every one of ``n_iter`` 2 steps (the loop left by its trip count) or
    more than one of 8, and a QP with a NaN in Quu (NaN point, the loop done
    at once)."""
    QPs = _pnqp_loop_cases(m, 400, 1600 + 10 * m + n_iter)
    want = _pnqp_loop(host_lib, m, -1, QPs, n_iter)
    x, _, n_qp = want
    assert bool((n_qp[: 400 // 8] == 1).all()) and bool((n_qp == n_iter).any() if n_iter == 2 else (n_qp > 1).any())
    assert bool(np.isnan(x[-1]).all()) and n_qp[-1] == 1 and bool(np.isfinite(x[:-1]).all())
    for which in (0, *ILQR_LANES):
        got = _pnqp_loop(host_lib, m, which, QPs, n_iter)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32), err_msg=f"loop {which}")


@pytest.mark.parametrize("mode", ["free", "box", "mask"])
@pytest.mark.parametrize("n,m", [(3, 1), (4, 2)])
def test_host_build_riccati_simplified_value_update_matches_plain(
    host_riccati_launch, host_riccati_stream_launch, n, m, mode
):
    """``value_update_exact_reg=1e-6`` (the simplified value update, engaged
    in every mode at m <= 2): the host build at one lane holds the plain
    version's rule with the flag on, and parts from the full form; every L
    of both kernels equals one lane bit for bit."""
    args, kw = _riccati_lane_case(n, m, mode, True, 1580 + 10 * n + m)
    kw["value_update_exact_reg"] = 1e-6
    one = run_staged_riccati(host_riccati_launch, *args, **kw)
    _assert_riccati_matches(one, riccati_backward_plain(*args, **kw))
    full = run_staged_riccati(host_riccati_launch, *args, **dict(kw, value_update_exact_reg=-1.0))
    assert not torch.equal(one.K, full.K)
    _riccati_every_lane_count((host_riccati_launch, host_riccati_stream_launch), args, kw, one)


@pytest.mark.parametrize(
    "n,m,box,delta_u,max_iter",
    [(3, 2, False, None, 6), (4, 2, True, None, 6), (4, 2, True, 0.8, 10), (4, 2, True, None, 13)],
    ids=["free", "box", "box_delta_u", "two_ladder_chunks"],
)
def test_host_build_linear_rollout_twin_matches_plain_and_resident(
    host_rollout_launch, host_rollout_stream_launch, n, m, box, delta_u, max_iter
):
    """max_iter 13: one lane runs the ladder in two passes (10 candidates,
    then 3)."""
    T, B = 7, 37
    rng = np.random.default_rng(960 + 10 * n + m + box)
    C, c, F, f, x0 = (torch.tensor(a, dtype=torch.float32) for a in random_lqr_problem(rng, T, B, n, m))
    u_hat = torch.tensor(rng.uniform(-0.3, 0.3, (T, B, m)), dtype=torch.float32)
    x_hat, _ = lqr_rollout(x0, F, f, torch.zeros(T, B, m, n), torch.zeros(T, B, m), u_hat=u_hat)
    K = torch.tensor(rng.normal(size=(T, B, m, n)) * 0.3, dtype=torch.float32)
    k = torch.tensor(rng.normal(size=(T, B, m)) * (1.0 + 4.0 * (max_iter > 10)), dtype=torch.float32)
    kw = dict(delta_u=delta_u, decay=0.5, max_iter=max_iter)
    if box:
        kw.update(u_lower=torch.tensor(-0.7), u_upper=torch.full((T, B, m), 0.7))
    args = (x0, C, c, F, f, K, k, x_hat, u_hat)
    got = run_staged_rollout(host_rollout_stream_launch, *args, **kw)
    _assert_rollout_matches(got, linesearch_rollout_plain(*args, **kw))
    _assert_equal_results(got, run_staged_rollout(host_rollout_launch, *args, **kw))
    assert len(np.unique(got.alpha.numpy())) > 1


def test_host_build_pendulum_rollout_twin_matches_plain_and_resident(host_rollout_launch, host_rollout_stream_launch):
    prob = make_problem(seed=970, batched_params=True, warm=True)
    t, dx = torch_inputs(prob)
    T, B = t["C"].shape[:2]
    rng = np.random.default_rng(971)
    x_hat = torch.tensor(rng.normal(size=(T, B, 3)), dtype=torch.float32)
    u_hat = t["u_init"].clamp(-2.0, 2.0)
    K = torch.tensor(rng.normal(size=(T, B, 1, 3)) * 0.5, dtype=torch.float32)
    k = torch.tensor(rng.normal(size=(T, B, 1)), dtype=torch.float32)
    args = (t["x_init"], t["C"], t["c"], None, None, K, k, x_hat, u_hat)
    kw = dict(u_lower=t["u_lower"], u_upper=t["u_upper"], dyn=dx, delta_u=1.0)
    got = run_staged_rollout(host_rollout_stream_launch, *args, **kw)
    _assert_rollout_matches(got, linesearch_rollout_plain(*args, **kw))
    _assert_equal_results(got, run_staged_rollout(host_rollout_launch, *args, **kw))


# ---------------------------------------------------------------------------
# The line search by lane groups (rollout.cuh): every built L against one,
# its slices read from the arrays (the resident kernel's MLP step) and
# staged (the twin, and the resident kernel's cheap steps).
# ---------------------------------------------------------------------------


def _rollout_lane_case(case, seed, n_alpha, T=7, B=37):
    """``(args, kw)`` of the lane tests: linear (3, 2) unconstrained, linear
    (4, 2) with a box, with a box and ``delta_u``; the pendulum with every
    knob; the ``n3m1_h8`` MLP. The feedforward is scaled by up to 8 and the
    ladder's decay is 0.5, so that the picks spread over the ladder."""
    rng = np.random.default_rng(seed)
    if case in ("pendulum", "mlp"):
        if case == "pendulum":
            t, dyn = torch_inputs(make_problem(seed=seed, batched_params=True, warm=True, B=B, T=T))
            x0, C, c, lo, hi = t["x_init"], t["C"], t["c"], t["u_lower"], t["u_upper"]
            u_hat = t["u_init"].clamp(-2.0, 2.0)
        else:
            dyn, (x0, C, c, _, lo, hi) = _nn_problem(3, 1, "tanh", seed=seed, B=B, T=T)
            u_hat = torch.tensor(rng.uniform(-1.5, 1.5, (T, B, 1)), dtype=torch.float32)
        n, m, F, f = 3, 1, None, None
        x_hat = torch.tensor(rng.normal(size=(T, B, n)) * 0.3, dtype=torch.float32) + x0
        kw = dict(u_lower=lo, u_upper=hi, dyn=dyn, delta_u=1.0 if case == "pendulum" else None)
    else:
        n, m = (3, 2) if case == "free32" else (4, 2)
        C, c, F, f, x0 = (torch.tensor(a, dtype=torch.float32) for a in random_lqr_problem(rng, T, B, n, m))
        u_hat = torch.tensor(rng.uniform(-0.3, 0.3, (T, B, m)), dtype=torch.float32)
        x_hat, _ = lqr_rollout(x0, F, f, torch.zeros(T, B, m, n), torch.zeros(T, B, m), u_hat=u_hat)
        kw = dict(delta_u=0.8 if case == "box42_delta_u" else None)
        if case != "free32":
            kw.update(u_lower=torch.tensor(-0.7), u_upper=torch.full((T, B, m), 0.7))
    K = torch.tensor(rng.normal(size=(T, B, m, n)) * 0.3, dtype=torch.float32)
    k = torch.tensor(rng.normal(size=(T, B, m)) * rng.uniform(0.5, 8.0, (1, B, 1)), dtype=torch.float32)
    return (x0, C, c, F, f, K, k, x_hat, u_hat), dict(kw, decay=0.5, max_iter=n_alpha)


def _rollout_lane_launcher(host_lib, case, stream):
    """The host build's line search for a case of :func:`_rollout_lane_case`:
    the resident kernel or (``stream``) the twin; a refused launch raises."""
    if case == "mlp":
        fn = host_lib.diffmpc_rollout_nn_n3m1_h8_host
        fn.argtypes = [ctypes.POINTER(_RolloutArgs), ctypes.POINTER(_NNEnv), ctypes.c_int]
        fn.restype = ctypes.c_int

        def launch(args, n, m, env):
            assert fn(args, env, int(stream)) == 0, "refused"

        return launch
    fn = getattr(host_lib, "diffmpc_rollout_stream_host" if stream else "diffmpc_rollout_host")
    fn.argtypes = [ctypes.POINTER(_RolloutArgs), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(args, n, m, env):
        assert fn(args, n, m, env) == 0, "refused"

    return launch


ROLLOUT_LANE_CASES = ["free32", "box42", "box42_delta_u", "pendulum", "mlp"]


@pytest.mark.parametrize("n_alpha", [10, 3])
@pytest.mark.parametrize("case", ROLLOUT_LANE_CASES)
@pytest.mark.parametrize("stream", [False, True], ids=["direct", "staged"])
def test_host_build_rollout_lanes_equal_one_lane_and_match_plain(host_lib, stream, case, n_alpha):
    """Every built lane count, its slices read from the arrays or staged
    through the group's slots (the ladder in one pass, ceil(10 / L)
    candidates a lane, or for the MLP a round of one a lane a pass; the
    ballot's pick; each lane's first candidate's trajectory kept) equals the
    unstaged build at one lane bit for bit, which holds the plain version
    within the rollout tolerances; ``n_alpha`` 3 leaves lanes of the larger
    groups without a candidate."""
    args, kw = _rollout_lane_case(case, 1320 + 10 * ROLLOUT_LANE_CASES.index(case) + n_alpha, n_alpha)
    one = run_staged_rollout(_rollout_lane_launcher(host_lib, case, False), *args, **kw)
    _assert_rollout_matches(one, linesearch_rollout_plain(*args, **kw))
    assert len(np.unique(one.alpha.numpy())) > 1
    launch = _rollout_lane_launcher(host_lib, case, stream)
    for lanes in ROLLOUT_LANES:
        _assert_equal_results(run_staged_rollout(launch, *args, lanes=lanes, **kw), one)


@pytest.mark.parametrize("stream", [False, True], ids=["direct", "staged"])
def test_host_build_rollout_lanes_pick_past_the_first_round(host_lib, stream):
    """The pick when the first improving candidate lies past the lanes'
    first candidates, and past the first pass at one and two lanes: the box
    case with the feedforward scaled up and 13 candidates, where some
    scenarios pick the fifth or a later one (and a replay follows), solved
    by every L, equals one lane bit for bit."""
    args, kw = _rollout_lane_case("box42", 1390, 13)
    args = args[:6] + (args[6] * 4.0,) + args[7:]
    one = run_staged_rollout(_rollout_lane_launcher(host_lib, "box42", False), *args, **kw)
    _assert_rollout_matches(one, linesearch_rollout_plain(*args, **kw))
    picked = torch.round(torch.log2(one.alpha) / np.log2(kw["decay"]))[one.improved]
    assert int((picked >= 4).sum()) >= 2 and int((picked < 2).sum()) >= 2 and bool((picked >= 10).any())
    launch = _rollout_lane_launcher(host_lib, "box42", stream)
    for lanes in ROLLOUT_LANES:
        _assert_equal_results(run_staged_rollout(launch, *args, lanes=lanes, **kw), one)


# ladders of the line search with nothing improving: (decay, n_alpha, unroll)
NO_IMPROVEMENT_LADDERS = {
    # 0.2 * 0.2 in float32 is not float32(0.04), alpha_floor: the groups
    # without a lane past the ladder (one and two lanes) replay
    "rolled_off_floor": (0.2, 3, False),
    # halving lands on alpha_floor = 0.5**9 bit for bit
    "rolled_on_floor": (0.5, 10, False),
    # decay**k rounded once: the last step is alpha_floor
    "unrolled": (0.2, 4, True),
}


def _no_improvement_case(host_lib, case: str, ladder: str):
    """``(args, kw, launcher(stream))`` of a line search on which no
    candidate improves: linear (4, 2) dynamics about the problem's optimum
    (the plain free sweep's policy rolled out) with a random feedforward,
    every step up the quadratic; the pendulum, the ``n3m1_h8`` MLP and the
    acrobot (n + m = 7) with a zero cost, every candidate tying the
    baseline."""
    decay, n_alpha, unroll = NO_IMPROVEMENT_LADDERS[ladder]
    knobs = dict(decay=decay, max_iter=n_alpha, unroll=unroll)
    if case == "linear":
        rng = np.random.default_rng(1700)
        T, B, n, m = 7, 37, 4, 2
        C, c, F, f, x0 = (torch.tensor(a, dtype=torch.float32) for a in random_lqr_problem(rng, T, B, n, m))
        gains = riccati_backward_plain(C, c, F, f, n)
        x_hat, u_hat = lqr_rollout(x0, F, f, gains.K, gains.k)
        k = torch.tensor(rng.normal(size=(T, B, m)) * 20.0, dtype=torch.float32)
        args = (x0, C, c, F, f, gains.K, k, x_hat, u_hat)

        def launcher(stream):
            return _rollout_lane_launcher(host_lib, "box42", stream)

        return args, knobs, launcher
    if case == "acrobot":
        args, kw = _zoo_line_search_inputs("acrobot")
        launcher = _zoo_rollout_launcher(host_lib, "acrobot", kw["dyn"])
    else:
        args, kw = _rollout_lane_case(case, 1710, n_alpha)
        kw.pop("decay"), kw.pop("max_iter")

        def launcher(stream):
            return _rollout_lane_launcher(host_lib, case, stream)
    args = (args[0], torch.zeros_like(args[1]), torch.zeros_like(args[2])) + tuple(args[3:])
    return args, dict(kw, **knobs), launcher



@pytest.mark.parametrize("ladder", list(NO_IMPROVEMENT_LADDERS))
@pytest.mark.parametrize("case", ["linear", "pendulum", "mlp", "acrobot"])
def test_host_build_rollout_with_nothing_improving_equals_one_lane_and_plain(host_lib, case, ladder):
    """A line search on which no candidate improves (a converged solve's
    last call): the pick alpha_floor, its trajectory and cost from the slot
    of a lane whose first candidate of the last pass stepped by alpha_floor's
    bits (the lane past the ladder, or the ladder's last step) or, where no
    lane has one, the replay; at every built L, read from the arrays and
    staged, bit-equal to one lane, which holds the plain version's rule;
    under the rolled ladder that lands off alpha_floor and on it, and the
    unrolled one."""
    args, kw, launcher = _no_improvement_case(host_lib, case, ladder)
    want = linesearch_rollout_plain(*args, **kw)
    assert not bool(want.improved.any())
    one = run_staged_rollout(launcher(False), *args, **kw)
    _assert_rollout_matches(one, want)
    assert bool((one.alpha == np.float32(kw["decay"] ** (kw["max_iter"] - 1))).all())
    assert float((one.us - args[8]).abs().max()) > 1e-3  # the floor's step moved the controls
    for stream in (False, True):
        for lanes in ROLLOUT_LANES:
            _assert_equal_results(run_staged_rollout(launcher(stream), *args, lanes=lanes, **kw), one)


@pytest.mark.parametrize("case", ["free32", "box42_delta_u"])
def test_host_build_rollout_unroll_ladder_matches_plain(host_lib, case):
    """``unroll=True``: the ladder's alphas are the wrapper's float32
    ``decay**k``, which part from the rolled ladder's float32 products at
    k = 2 for decay 0.2. Every L of both kernels bit for bit one lane, which
    holds the plain version's ``unroll=True``; every alpha chosen one of the
    powers, the k = 2 pick among them."""
    args, kw = _rollout_lane_case(case, 1395, 10)
    kw = dict(kw, decay=0.2, unroll=True)
    powers = torch.tensor([0.2**k for k in range(10)], dtype=torch.float32)
    f32 = torch.tensor(0.2, dtype=torch.float32)
    assert f32 * f32 != powers[2]
    one = run_staged_rollout(_rollout_lane_launcher(host_lib, case, False), *args, **kw)
    _assert_rollout_matches(one, linesearch_rollout_plain(*args, **kw))
    assert bool(torch.isin(one.alpha, powers).all()) and bool((one.alpha == powers[2]).any())
    for stream in (False, True):
        launch = _rollout_lane_launcher(host_lib, case, stream)
        for lanes in ROLLOUT_LANES:
            _assert_equal_results(run_staged_rollout(launch, *args, lanes=lanes, **kw), one)


@pytest.mark.parametrize("case", ["box42", "mlp"])
def test_host_build_rollout_lane_scratch_is_refused_when_it_disagrees(host_lib, monkeypatch, case):
    """The lanes' trajectory scratch that ``run_staged_rollout`` allocates
    by ``rollout_keeps_lane_trajectories`` is taken at every built L, and
    with that rule turned round every L refuses the launch (the kernels'
    ``rollout_lane_scratch_ok``): scratch at one lane, none above it."""
    args, kw = _rollout_lane_case(case, 1398, 10)
    rule = rol_mod.rollout_keeps_lane_trajectories
    monkeypatch.setattr(rol_mod, "rollout_keeps_lane_trajectories", lambda lanes: not rule(lanes))
    for stream in (False, True):
        launch = _rollout_lane_launcher(host_lib, case, stream)
        for lanes in ROLLOUT_LANES:
            with pytest.raises(AssertionError, match="refused"):
                run_staged_rollout(launch, *args, lanes=lanes, **kw)


@pytest.mark.parametrize("T", [1, 8])
@pytest.mark.parametrize("n,m,n_tight", [(3, 1, 12), (3, 2, 20), (4, 1, 12), (4, 2, 20)])
def test_host_build_kkt_twin_matches_plain_and_resident(host_kkt_launch, host_kkt_stream_launch, n, m, n_tight, T):
    B = 37
    rng = np.random.default_rng(980 + 10 * n + m + T)
    res = random_residuals(rng, T, B, n, m, min(n_tight, T * B * m // 2))
    ins = [torch.tensor(a) for a in kernel_inputs(res)]
    got = run_staged_kkt(host_kkt_stream_launch, *ins, reg=1e-7)
    want = kkt_backward_plain(*ins, reg=1e-7)
    for name, g, w in zip(("dx_init", "dC", "dc", "dF", "df"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=1e-5, err_msg=name)
    _assert_equal_results(got, run_staged_kkt(host_kkt_launch, *ins, reg=1e-7))


# ---------------------------------------------------------------------------
# The KKT backward by lane groups (kkt.cuh): every built L of the resident
# kernel (K, k, p on chip and in device memory) and of the twin against one
# lane, sweep 1 against the Riccati sweep in mask mode, a shared C and F read
# in place.
# ---------------------------------------------------------------------------


def _kkt_variant_launcher(host_lib, exact: bool, twin: bool):
    fn = host_lib.diffmpc_kkt_variant_host
    fn.argtypes = [ctypes.POINTER(_KktArgs)] + [ctypes.c_int] * 4
    fn.restype = ctypes.c_int

    def launch(args, n, m):
        assert fn(args, n, m, int(exact), int(twin)) == 0, f"no host instantiation for n={n}, m={m}"

    return launch


def _kkt_lane_case(n, m, seed, T=7, B=13):
    """The KKT backward's float32 inputs: tests/torch_parity.py's residuals
    with ~15% of the controls tight."""
    res = random_residuals(np.random.default_rng(seed), T, B, n, m, max(1, T * B * m * 15 // 100))
    ins = [torch.tensor(a) for a in kernel_inputs(res)]
    assert bool(ins[-1].any()) and not bool(ins[-1].all())
    return ins


KKT_LANE_SHAPES = [(3, 1), (4, 2), (6, 3)]


@pytest.mark.parametrize("exact", [False, True], ids=["full", "simplified"])
@pytest.mark.parametrize("n,m", KKT_LANE_SHAPES)
def test_host_build_kkt_lanes_equal_one_lane(host_lib, n, m, exact):
    """One lane within ``1e-4 * max(1, max|plain|)`` of the plain version;
    the resident kernel with K, k and p on chip and in device memory and the
    twin, at every built lane count (``DMPC_LANES``: the card's
    ``KKT_LANES`` and 2 and 4, which do not divide every share evenly), and
    one lane loading each slice at its step rather than a step ahead, bit for
    bit the resident kernel at one lane."""
    ins = _kkt_lane_case(n, m, 1700 + 10 * n + m + exact)
    kw = dict(reg=1e-7)
    resident, twin = _kkt_variant_launcher(host_lib, exact, False), _kkt_variant_launcher(host_lib, exact, True)
    one = run_staged_kkt(resident, *ins, lanes=1, **kw)
    want = kkt_backward_plain(*ins, value_update_exact_reg=1e-6 if exact else -1.0, **kw)
    for name, g, w in zip(("dx_init", "dC", "dc", "dF", "df"), one, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4 * max(1.0, float(w.abs().max())), rtol=0,
                                   err_msg=name)
    assert set(KKT_LANES) <= set(ILQR_LANES)
    for lanes in ILQR_LANES:
        for launch, on_chip in ((resident, None), (resident, False), (twin, None)):
            _assert_equal_results(run_staged_kkt(launch, *ins, lanes=lanes, on_chip=on_chip, **kw), one)
    for launch in (resident, twin):
        _assert_equal_results(run_staged_kkt(launch, *ins, lanes=1, on_chip=False, prefetch=False, **kw), one)


@pytest.mark.parametrize("exact", [False, True], ids=["full", "simplified"])
@pytest.mark.parametrize("n,m", KKT_LANE_SHAPES)
def test_host_build_kkt_gains_equal_the_mask_mode_riccati_sweep(host_lib, host_riccati_launch, n, m, exact):
    """Sweep 1's gains (the twin keeps them in device memory) at every built
    lane count equal bit for bit the Riccati sweep's in mask mode on
    ``(C, r, F, tight)``: the Riccati sweep the composite backward runs
    (ops/lqr_step.py), the same step."""
    C, c, F, r, tau, tight = _kkt_lane_case(n, m, 1760 + 10 * n + m + exact)
    threshold = 1e-6 if exact else -1.0
    if (n, m) == (6, 3):
        fn = host_lib.diffmpc_riccati_mask63_host
        fn.argtypes, fn.restype = [ctypes.POINTER(_RiccatiArgs)], ctypes.c_int

        def riccati_launch(args, n_, m_, mode):
            assert fn(args) == 0
    else:
        riccati_launch = host_riccati_launch
    want = run_staged_riccati(riccati_launch, C, r, F, None, n, ctrl_mask=tight, reg=1e-7,
                              value_update_exact_reg=threshold)
    launch = _kkt_variant_launcher(host_lib, exact, True)
    for lanes in ILQR_LANES:
        staged = stage_kkt(C, c, F, r, tau, tight, reg=1e-7, lanes=lanes)
        launch(ctypes.byref(staged.args), n, m)
        K, k = staged.gains()
        np.testing.assert_array_equal(K.numpy(), want.K.numpy(), err_msg=f"K at L={lanes}")
        np.testing.assert_array_equal(k.numpy(), want.k.numpy(), err_msg=f"k at L={lanes}")


@pytest.mark.parametrize("n,m", [(3, 1), (4, 2)])
def test_host_build_kkt_reads_a_shared_C_and_F_in_place(host_kkt_launch, host_kkt_stream_launch, n, m):
    """A C shared by every step and scenario and an F shared by every
    scenario (batch stride 0, as ``mpc_solve`` expands a ``QuadCost``'s C
    and a ``LinDx``'s F) reach the kernels where they lie, and give bit for
    bit the outputs of their staged copies, at one lane and sixteen, resident
    and twin."""
    C, c, F, r, tau, tight = _kkt_lane_case(n, m, 1790 + 10 * n + m)
    T, B = C.shape[:2]
    C1 = C[0, 0] @ C[0, 0].T / (n + m) + torch.eye(n + m)
    C_shared, F_shared = C1.expand(T, B, n + m, n + m), F[:, :1].expand(T, B, n, n + m)
    assert reads_in_place(C_shared) and reads_in_place(F_shared) and not reads_in_place(F)
    staged = stage_kkt(C_shared, c, F_shared, r, tau, tight)
    assert staged.buffers[0].data_ptr() == C1.data_ptr() and staged.buffers[2].data_ptr() == F_shared.data_ptr()
    assert (staged.args.C_t, staged.args.C_e, staged.args.C_b) == (0, 1, 0)
    assert (staged.args.F_t, staged.args.F_e, staged.args.F_b) == (F.stride(0), 1, 0)
    ins = (C_shared, c, F_shared, r, tau, tight)
    copies = (C_shared.contiguous(), c, F_shared.contiguous(), r, tau, tight)
    for launch in (host_kkt_launch, host_kkt_stream_launch):
        for lanes in (1, 16):
            _assert_equal_results(run_staged_kkt(launch, *ins, lanes=lanes), run_staged_kkt(launch, *copies, lanes=lanes))


# ---------------------------------------------------------------------------
# The depth-blocked sweep and the piece-decomposition kernels.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_blocked_fn(host_lib):
    fn = host_lib.diffmpc_riccati_blocked_host
    fn.argtypes = [ctypes.POINTER(_BlockedArgs)] + [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return fn


def _blocked_host_launch(fn, sms=132, max_threads=1024, cap=1 << 30):
    """The host build's blocked sweep, its threads placed as the card's
    launcher places them for ``sms`` SMs, ``max_threads`` and at most ``cap``
    scenarios a CTA."""

    def launch(args, n, m):
        err = fn(args, n, m, sms, max_threads, cap)
        assert err == 0, f"host blocked sweep at n={n}, m={m}: error {err}"

    return launch


@pytest.fixture(scope="module")
def host_blocked_launch(host_blocked_fn):
    return _blocked_host_launch(host_blocked_fn)


def _assert_blocked_close(got, want):
    for name in ("K", "k"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5 * max(1.0, float(w.abs().max())), rtol=0, err_msg=name)
    assert bool(got.free_mask.all()) and not bool(got.n_qp_iter.any())


@pytest.mark.parametrize("with_f", [False, True], ids=["f_none", "with_f"])
@pytest.mark.parametrize("block", [2, 4])
@pytest.mark.parametrize("n,m", [(3, 1), (3, 2), (4, 1), (4, 2)])
def test_host_build_riccati_blocked_matches_plain(host_blocked_launch, n, m, block, with_f):
    """The blocked sweep's host build (the card's geometry) against its
    plain version within ``1e-5 * max(1, max|plain|)`` (the same float32
    arithmetic in the same order; g++ and PyTorch round the same operations),
    ``free`` all true."""
    T, B = 8, 37
    rng = np.random.default_rng(990 + 10 * n + m + block)
    C, c, F, f, _ = (torch.tensor(a, dtype=torch.float32) for a in random_lqr_problem(rng, T, B, n, m))
    f = f if with_f else None
    got = run_staged_blocked(host_blocked_launch, C, c, F, f, n, block=block)
    want = riccati_backward_blocked_plain(C, c, F, f, n, block=block)
    _assert_blocked_close(got, want)


@pytest.mark.parametrize("T,block", [(128, 2), (20, 4), (20, 2), (8, 4)], ids=["P64", "P5", "P10", "P2"])
@pytest.mark.parametrize("n,m", [(3, 1), (3, 2), (4, 1), (4, 2)])
def test_host_build_riccati_blocked_threads_match_plain(host_blocked_fn, n, m, T, block):
    """The (block, scenario) threads CTA by CTA as the card places them (a
    card of 132 SMs and 1024 threads a CTA, of 2 SMs and 256, and of 2 SMs
    with at most 3 scenarios a CTA: other CTA widths, the ragged last CTA of
    B = 37), phase by phase in the kernel's order: every (block, scenario)
    on one thread, every carry the card shuffles within its warp, and
    ``K, k`` within ``1e-5 * max(1, max|plain|)`` of the plain version.
    T / D = 64 spans two warps a scenario (the carry through shared memory);
    5 and 10 are not powers of two."""
    B = 37
    rng = np.random.default_rng(1170 + T + 10 * n + m + block)
    C, c, F, f, _ = (torch.tensor(a, dtype=torch.float32) for a in random_lqr_problem(rng, T, B, n, m))
    want = riccati_backward_blocked_plain(C, c, F, f, n, block=block)
    for sms, max_threads, cap in ((132, 1024, 1 << 30), (2, 256, 1 << 30), (2, 1024, 3)):
        got = run_staged_blocked(_blocked_host_launch(host_blocked_fn, sms, max_threads, cap), C, c, F, f, n,
                                 block=block)
        _assert_blocked_close(got, want)


def _max_blocks_py(n: int, D: int, max_threads: int, smem_max: int) -> int:
    """blocked_max_blocks from its definition: the most blocks P whose
    threads (P rounded up to whole warps) fit ``max_threads`` and whose
    columns, with two carry slots where P passes one warp, fit
    ``smem_max`` bytes."""
    column = 4 * (1 if D == 2 else 4) * (3 * n * n + 2 * n)
    carry = 4 * (n * (n + 1) // 2 + n)
    fits = [P for P in range(1, max_threads + 1)
            if -(-P // 32) * 32 <= max_threads and -(-P // 32) * 32 * column + (2 * carry if P > 32 else 0) <= smem_max]
    return max(fits, default=0)


@pytest.mark.parametrize("block", [2, 4])
@pytest.mark.parametrize("n,m", [(3, 1), (4, 2)])
def test_host_build_riccati_blocked_longest_horizon(host_lib, host_blocked_fn, n, m, block):
    """One CTA holds a scenario's T / D threads: the longest horizon is D
    times blocked_max_blocks, bound by the kernel's threads a CTA (256 at
    (4, 2)'s 254 registers) or by the columns' shared memory (227 KB on the
    card, or less), whichever binds first. At a CTA of 32 threads the sweep
    runs at T = 32 D and agrees with the plain version; one block more is
    refused (the card's launcher returns cudaErrorInvalidValue, and its
    wrapper raises ValueError before it)."""
    mb = host_lib.diffmpc_riccati_blocked_max_blocks_host
    mb.argtypes, mb.restype = [ctypes.c_int] * 5, ctypes.c_int
    for max_threads, smem in ((256, 227 * 1024), (1024, 227 * 1024), (1024, 48 * 1024), (32, 227 * 1024)):
        assert mb(n, m, block, max_threads, smem) == _max_blocks_py(n, block, max_threads, smem)
    assert mb(n, m, block, 256, 227 * 1024) == 256
    assert mb(n, m, block, 32, 227 * 1024) == 32
    B = 5
    rng = np.random.default_rng(1230 + 10 * n + m + block)
    C, c, F, f, _ = (torch.tensor(a, dtype=torch.float32) for a in random_lqr_problem(rng, 33 * block, B, n, m))
    T = 32 * block
    got = run_staged_blocked(_blocked_host_launch(host_blocked_fn, sms=132, max_threads=32), C[:T], c[:T], F[:T],
                             f[:T], n, block=block)
    _assert_blocked_close(got, riccati_backward_blocked_plain(C[:T], c[:T], F[:T], f[:T], n, block=block))
    refused = []
    run_staged_blocked(lambda args, n, m: refused.append(host_blocked_fn(args, n, m, 132, 32, 1 << 30)), C, c, F, f, n,
                       block=block)
    assert refused == [2]


@pytest.fixture(scope="module")
def host_pieces_launch(host_lib):
    fn = host_lib.diffmpc_riccati_pieces_host
    fn.argtypes = [ctypes.POINTER(_PieceArgs), ctypes.POINTER(_PendulumEnv), ctypes.c_int]
    fn.restype = ctypes.c_int

    def launch(args, env, variant):
        assert fn(args, env, -1 if variant == "rollout" else PIECE_VARIANTS.index(variant)) == 0

    return launch


def _piece_inputs(T, B, seed):
    """The inputs of scripts/profile_riccati_pieces.py: the pendulum's goal
    cost, a random trajectory, the box +-2."""
    from diffmpc_tpu_torch.models import PendulumDx

    dx = PendulumDx.default(device="cpu")
    q, p = dx.get_true_obj()
    rng = np.random.default_rng(seed)
    xh = torch.tensor(rng.normal(size=(T, B, 3)), dtype=torch.float32)
    uh = torch.tensor(rng.normal(size=(T, B, 1)) * 0.5, dtype=torch.float32)
    box = torch.full((T, B, 1), 2.0)
    return (torch.diag(q).expand(T, B, 4, 4), p.expand(T, B, 4), xh, uh, -box, box, dx)


@pytest.mark.parametrize("reps", [1, 3])
@pytest.mark.parametrize("variant", PIECE_VARIANTS + ("rollout",))
def test_host_build_riccati_pieces_match_plain(host_pieces_launch, variant, reps):
    """Each piece kernel's host build (the sweep at one lane reading the
    arrays) against its plain version: the sweep's ``K, k`` within
    ``1e-4 * max(1, max|plain|)`` (the Jacobian by dual numbers against the
    plain version's forward-mode autodiff, with their own sin/cos), the
    rollout's objective within 1e-5 relative."""
    ins = _piece_inputs(6, 37, 1000 + reps)
    got = run_staged_pieces(host_pieces_launch, variant, *ins, reps=reps)
    if variant == "rollout":
        want = rollout_piece_plain(*ins, reps=reps).obj
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=0)
        return
    want = sweep_piece_plain(variant, *ins, reps=reps)
    for name in ("K", "k"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4 * max(1.0, float(w.abs().max())), rtol=0, err_msg=name)


@pytest.mark.parametrize("variant", PIECE_VARIANTS + ("rollout",))
def test_host_build_riccati_pieces_lane_groups_bit_equal(host_pieces_launch, variant):
    """The piece sweep and the rollout at every built lane count, staged
    through the group's ring and reading the arrays, at reps 1 and 3 (the
    ring restarted each pass; T = 7 leaves it part full): bit-equal to one
    lane reading the arrays, and within ``1e-4 * max(1, max|plain|)`` of the
    plain version (the rollout's objective within 1e-5 relative)."""
    kinds = PIECE_VARIANTS + ("rollout",)
    ins = _piece_inputs(7, 21, 1300 + kinds.index(variant))
    for reps in (1, 3):
        one = run_staged_pieces(host_pieces_launch, variant, *ins, reps=reps, lanes=1, staged=False)
        if variant == "rollout":
            want = rollout_piece_plain(*ins, reps=reps).obj
            np.testing.assert_allclose(one.numpy(), want.numpy(), rtol=1e-5, atol=0)
            one = (one,)
        else:
            want = sweep_piece_plain(variant, *ins, reps=reps)
            for g, w in zip(one, want):
                np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4 * max(1.0, float(w.abs().max())), rtol=0)
        for lanes in PIECE_LANES:
            for staged in (False, True):
                got = run_staged_pieces(host_pieces_launch, variant, *ins, reps=reps, lanes=lanes, staged=staged)
                for g, o in zip((got,) if variant == "rollout" else got, one):
                    assert torch.equal(g, o), (lanes, staged, reps)
    with pytest.raises(ValueError, match="lanes must be one of"):
        run_staged_pieces(host_pieces_launch, variant, *ins, lanes=3)


# ---------------------------------------------------------------------------
# The MLP step (nn_mlp.cuh) and the HoistLin pre-pass of the fused solve.
# ---------------------------------------------------------------------------


def _nn_problem(n, m, activation, seed, B=37, T=6):
    """A residual MLP with one hidden layer of 8 (He-normal weights scaled by
    0.3, so that six steps keep the state near its start and the objectives
    near 1, and biases perturbed so that their place in ``kernel_params``
    shows), on the goal cost of tests/test_pallas_ilqr.py's NN test, box
    +-2."""
    gen = torch.Generator().manual_seed(seed)
    nn = NNDynamics.init(n, m, hidden=(8,), activation=activation, residual=True, device="cpu", generator=gen)
    nn = nn.replace(
        weights=tuple(0.3 * w for w in nn.weights),
        biases=tuple(b + 0.05 * torch.randn(b.shape, generator=gen) for b in nn.biases),
    )
    nm = n + m
    q = torch.tensor([1.0, 1.0, 0.1] + [0.001] * m)
    p = torch.zeros(nm)
    p[0] = -1.0
    x0 = torch.randn((B, n), generator=gen) * 0.5
    box = torch.full((T, B, m), 2.0)
    return nn, (x0, torch.diag(q).expand(T, B, nm, nm), p.expand(T, B, nm), nn, -box, box)


def _nn_launcher(host_lib, symbol, struct=_NNEnv):
    return _ilqr_launcher(host_lib, symbol, struct)


@pytest.mark.parametrize("activation", list(ACTIVATIONS))
def test_host_build_nn_solve_matches_plain(host_lib, activation):
    """One iteration through the MLP step, every activation: within 1e-4 of
    the plain version with ``n_iters`` equal; the HoistLin build bit for bit
    the build without it (the same float32 operations on the same values)."""
    _, args = _nn_problem(3, 1, activation, seed=1100 + list(ACTIVATIONS).index(activation))
    knobs = dict(lqr_iter=1, eps=0.0)
    host = run_staged(_nn_launcher(host_lib, "diffmpc_ilqr_solve_nn_n3m1_h8_host"), *args, **knobs)
    assert_tight(as_numpy(host), as_numpy(ilqr_solve_plain(*args, **knobs)))
    hoisted = run_staged(_nn_launcher(host_lib, "diffmpc_ilqr_solve_nn_n3m1_h8_hoist_host"), *args, hoist_lin=True, **knobs)
    _assert_equal_results(hoisted, host)


def test_host_build_nn_two_controls_over_iterations(host_lib):
    """m = 2 (the box QP's enumeration) through the MLP step: one iteration
    within 1e-4 of the plain version, four by the chaos rule; HoistLin bit
    for bit the build without it over the four."""
    _, args = _nn_problem(3, 2, "tanh", seed=1110)
    one, four = dict(lqr_iter=1, eps=0.0), dict(lqr_iter=4, eps=1e-5)
    launch = _nn_launcher(host_lib, "diffmpc_ilqr_solve_nn_n3m2_h8_host")
    assert_tight(as_numpy(run_staged(launch, *args, **one)), as_numpy(ilqr_solve_plain(*args, **one)))
    host = run_staged(launch, *args, **four)
    assert_chaos(as_numpy(host), as_numpy(ilqr_solve_plain(*args, **four)))
    hoisted = run_staged(_nn_launcher(host_lib, "diffmpc_ilqr_solve_nn_n3m2_h8_hoist_host"), *args, hoist_lin=True, **four)
    _assert_equal_results(hoisted, host)


def test_host_build_hoist_lin_leaves_the_pendulum_solve_unchanged(host_launch, host_lib):
    """The pendulum with the pre-pass equals the solve without it bit for bit
    over six iterations with every knob (per-scenario params, a warm start,
    ``delta_u``). Without the flag the header computes what it computed
    before the pre-pass existed (the same g++ build of the pre-pass's parent
    header gave bit-equal outputs when it was added)."""
    t, dx = torch_inputs(make_problem(seed=1120, warm=True, batched_params=True))
    args = (t["x_init"], t["C"], t["c"], dx, t["u_lower"], t["u_upper"])
    knobs = dict(u_init=t["u_init"], lqr_iter=6, eps=1e-5, delta_u=0.5)
    plain = run_staged(host_launch, *args, **knobs)
    hoisted = run_staged(
        _nn_launcher(host_lib, "diffmpc_ilqr_solve_pendulum_hoist_host", _PendulumEnv), *args, hoist_lin=True, **knobs
    )
    _assert_equal_results(hoisted, plain)
    assert (plain.n_iters >= 2).float().mean() > 0.5


# ---------------------------------------------------------------------------
# The fused solve by lane groups (ilqr.cuh): 4 and 16 lanes against one.
# ---------------------------------------------------------------------------


def _lane_case(env, hoist, seed):
    """``(symbol, struct, args, knobs)`` of the lane tests: the pendulum
    with every knob (per-scenario params, a warm start, ``delta_u``) or the
    ``n3m1_h8`` MLP, with ``hoist_lin`` as given and the ladder's decay 0.5,
    so that the picks spread over the ladder."""
    if env == "pendulum":
        t, dx = torch_inputs(make_problem(seed=seed, warm=True, batched_params=True))
        args = (t["x_init"], t["C"], t["c"], dx, t["u_lower"], t["u_upper"])
        knobs = dict(u_init=t["u_init"], delta_u=0.5)
        symbol, struct = "diffmpc_ilqr_solve_pendulum", _PendulumEnv
    else:
        _, args = _nn_problem(3, 1, "tanh", seed=seed)
        knobs = {}
        symbol, struct = "diffmpc_ilqr_solve_nn_n3m1_h8", _NNEnv
    symbol += ("_hoist" if hoist else "") + "_host"
    return symbol, struct, args, dict(knobs, decay=0.8, hoist_lin=hoist)


@pytest.mark.parametrize("n_alpha", [1, 10, 20])
@pytest.mark.parametrize("hoist", [False, True], ids=["in_sweep", "hoist_lin"])
@pytest.mark.parametrize("env", ["pendulum", "nn_n3m1_h8"])
def test_host_build_lane_groups_equal_one_lane_and_match_plain(host_lib, env, hoist, n_alpha):
    """A group of 4 or 16 lanes a scenario (the ladder a round of L
    candidates at a time: ``n_alpha`` shorter than the group, longer than
    four, longer than sixteen; the slices staged through the group's slots;
    the pre-pass shared out) equals one lane bit for bit over six
    iterations; one lane holds the plain version by the chaos rule over four
    iterations, and 16 lanes within 1e-4 after one."""
    symbol, struct, args, knobs = _lane_case(env, hoist, seed=1130 + n_alpha + 7 * hoist)
    knobs["max_linesearch_iter"] = n_alpha
    launch = _ilqr_launcher(host_lib, symbol, struct)
    six = dict(knobs, lqr_iter=6, eps=1e-5)
    one = run_staged(launch, *args, **six)
    for lanes in (4, 16):
        _assert_equal_results(run_staged(launch, *args, lanes=lanes, **six), one)
    four = dict(knobs, lqr_iter=4, eps=1e-5)
    assert_chaos(as_numpy(run_staged(launch, *args, **four)), as_numpy(ilqr_solve_plain(*args, **four)))
    first = dict(knobs, lqr_iter=1, eps=0.0)
    assert_tight(as_numpy(run_staged(launch, *args, lanes=16, **first)), as_numpy(ilqr_solve_plain(*args, **first)))


def test_host_build_lane_groups_pick_past_the_first_round(host_lib):
    """The pick when the first improving candidate lies in a later round or
    on a later lane than the first: the MLP problem whose last iteration
    backs off past the fourth candidate on some scenarios (not the ladder's
    floor), solved by 4 and 16 lanes, equals one lane bit for bit."""
    symbol, struct, args, knobs = _lane_case("nn_n3m1_h8", False, seed=1150)
    six = dict(knobs, max_linesearch_iter=20, lqr_iter=6, eps=1e-5)
    launch = _ilqr_launcher(host_lib, symbol, struct)
    one = run_staged(launch, *args, **six)
    decay = knobs["decay"]
    assert int(((one.alpha < decay**3) & (one.alpha > decay**19)).sum()) >= 2
    for lanes in (4, 16):
        _assert_equal_results(run_staged(launch, *args, lanes=lanes, **six), one)


def test_host_build_unroll_ladder_matches_plain(host_lib):
    """``unroll=True``: the ladder's alphas are the wrapper's float32
    ``decay**k``, which part from the rolled ladder's float32 products at
    k = 2 for decay 0.2. On the MLP problem whose last iteration picks k = 2
    on a scenario: one iteration within 1e-4 of the plain version's
    ``unroll=True``, four by the chaos rule; 4 and 16 lanes bit for bit one;
    every alpha the kernel and the plain version chose one of the powers,
    the k = 2 pick among them."""
    symbol, struct, args, knobs = _lane_case("nn_n3m1_h8", False, seed=1165)
    knobs["decay"] = 0.2
    powers = torch.tensor([0.2**k for k in range(10)], dtype=torch.float32)
    f32 = torch.tensor(0.2, dtype=torch.float32)
    assert f32 * f32 != powers[2]
    launch = _ilqr_launcher(host_lib, symbol, struct)
    first = dict(knobs, lqr_iter=1, eps=0.0, unroll=True)
    assert_tight(as_numpy(run_staged(launch, *args, **first)), as_numpy(ilqr_solve_plain(*args, **first)))
    four = dict(knobs, lqr_iter=4, eps=1e-5, unroll=True)
    one = run_staged(launch, *args, **four)
    plain = ilqr_solve_plain(*args, **four)
    assert_chaos(as_numpy(one), as_numpy(plain))
    for lanes in (4, 16):
        _assert_equal_results(run_staged(launch, *args, lanes=lanes, **four), one)
    for alpha in (one.alpha, plain.alpha):
        assert bool(torch.isin(alpha, powers).all()) and bool((alpha == powers[2]).any())


def test_built_lane_counts_are_one_list():
    """The lane counts the kernels are instantiated for (``DMPC_LANES`` in
    ``csrc/lanes.cuh``), the kernel files ``csrc/ilqr_nn_l<L>.cu`` and
    ``csrc/rollout_nn_l<L>.cu``, the piece sweep's ``csrc/riccati_pieces_l<L>.cu``
    and the wrappers' ``ILQR_LANES``, ``ROLLOUT_LANES`` and ``PIECE_LANES``
    are one list; the Riccati sweep's
    (``DMPC_RICCATI_LANES`` in ``csrc/riccati_launch.cuh``, the files
    ``csrc/riccati_l<L>.cu`` and ``RICCATI_LANES``) are another, and the KKT
    backward's (``DMPC_KKT_LANES`` in ``csrc/kkt_launch.cuh``, the files
    ``csrc/kkt_l<L>.cu`` and ``KKT_LANES``) a third, each within it and with
    one lane."""

    def macro(header, name):
        with open(os.path.join(build.CSRC, header)) as f:
            text = re.search(rf"#define {name}\(X, A\) (.*)", f.read()).group(1)
        return tuple(int(L) for L in re.findall(r"X\(A, (\d+)\)", text))

    def files(kind):
        return tuple(sorted(int(re.search(r"_l(\d+)\.cu$", p).group(1))
                            for p in glob.glob(os.path.join(build.CSRC, f"{kind}_l*.cu"))))

    in_header = macro("lanes.cuh", "DMPC_LANES")
    for kind in ("ilqr_nn", "rollout_nn"):
        assert in_header == files(kind) == ILQR_LANES == ROLLOUT_LANES
    riccati = macro("riccati_launch.cuh", "DMPC_RICCATI_LANES")
    assert riccati == files("riccati") == RICCATI_LANES
    assert 1 in riccati and set(riccati) <= set(in_header)
    assert in_header == files("riccati_pieces") == PIECE_LANES
    kkt = macro("kkt_launch.cuh", "DMPC_KKT_LANES")
    assert kkt == files("kkt") == KKT_LANES
    assert 1 in kkt and set(kkt) <= set(in_header)


@pytest.mark.parametrize("hoist", [False, True], ids=["in_sweep", "hoist_lin"])
@pytest.mark.parametrize("env", ["pendulum", "nn_n3m1_h8"])
def test_host_build_every_built_lane_count_takes_the_wrappers_scratch(host_lib, monkeypatch, env, hoist):
    """At every built lane count the host build accepts the lanes'
    trajectory scratch that ``run_staged`` allocates by
    ``keeps_lane_trajectories`` and equals one lane bit for bit; with that
    rule turned round, every lane count above one refuses the launch (the
    kernel's ``ilqr_lane_scratch_ok``), so the wrapper's rule and the
    kernel's ``ilqr_keeps_lanes`` cannot part unnoticed."""
    symbol, struct, args, knobs = _lane_case(env, hoist, seed=1190 + 3 * hoist)
    launch = _ilqr_launcher(host_lib, symbol, struct)
    three = dict(knobs, lqr_iter=3, eps=1e-5)
    one = run_staged(launch, *args, **three)
    for lanes in ILQR_LANES[1:]:
        _assert_equal_results(run_staged(launch, *args, lanes=lanes, **three), one)
    rule = ilqr_mod.keeps_lane_trajectories
    monkeypatch.setattr(ilqr_mod, "keeps_lane_trajectories", lambda e, lanes: not rule(e, lanes))
    for lanes in ILQR_LANES[1:]:
        with pytest.raises(AssertionError, match="refused"):
            run_staged(launch, *args, lanes=lanes, **three)


@pytest.mark.parametrize("activation", ["tanh", "softplus"])
def test_host_build_nn_rollout_and_twin_match_plain(host_lib, activation):
    """The line search through the MLP step: the resident kernel's host build
    against the plain version (the rollout tolerances above), the twin's bit
    for bit the resident's. The inputs are the non-fused loop's: a rollout
    of random controls, the box sweep's gains about it, the feedforward
    scaled by up to 8 so that the ladder backs off."""
    nn, (x0, C, c, _, lo, hi) = _nn_problem(3, 1, activation, seed=1130)
    T, B = C.shape[:2]
    gen = torch.Generator().manual_seed(1131)
    u_hat = torch.rand((T, B, 1), generator=gen) * 3.0 - 1.5
    xs = [x0]
    for t in range(T - 1):
        xs.append(nn.forward(xs[-1], u_hat[t]))
    x_hat = torch.stack(xs)
    F, _ = linearize_dynamics(nn, x_hat, u_hat)
    gains = riccati_backward_plain(C, c + bmv(C, torch.cat([x_hat, u_hat], -1)), F, None, 3, u_lower=lo, u_upper=hi, u_hat=u_hat)
    k = gains.k * (0.5 + 7.5 * torch.rand((1, B, 1), generator=gen))
    args = (x0, C, c, None, None, gains.K, k, x_hat, u_hat)
    kw = dict(u_lower=lo, u_upper=hi, dyn=nn, delta_u=1.0)
    fn = host_lib.diffmpc_rollout_nn_n3m1_h8_host
    fn.argtypes = [ctypes.POINTER(_RolloutArgs), ctypes.POINTER(_NNEnv), ctypes.c_int]
    fn.restype = ctypes.c_int

    def launcher(stream):
        def launch(args, n, m, env):
            assert fn(args, env, stream) == 0

        return launch

    got = run_staged_rollout(launcher(0), *args, **kw)
    _assert_rollout_matches(got, linesearch_rollout_plain(*args, **kw))
    _assert_equal_results(run_staged_rollout(launcher(1), *args, **kw), got)
    assert len(np.unique(got.alpha.numpy())) > 1


def test_build_keys_library_by_sources_and_reports_nvcc_errors(tmp_path, monkeypatch):
    """csrc/build.py on the CPU: a stand-in nvcc shows the command, the
    hash-keyed name and the rename into place, and that a failed build
    raises with the compiler's output and leaves no partial file."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text(
        "#!/bin/sh\n"
        'if [ -n "$FAKE_NVCC_FAIL" ]; then echo "error: bad kernel" >&2; exit 2; fi\n'
        'while [ "$#" -gt 0 ]; do if [ "$1" = "-o" ]; then shift; echo lib > "$1"; fi; shift; done\n'
    )
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    with pytest.raises(RuntimeError, match="bad kernel"):
        build.build()
    assert not os.listdir(tmp_path / "out")
    monkeypatch.delenv("FAKE_NVCC_FAIL")
    so, _ = build.build()
    assert so == build.library_path() and os.path.exists(so)
    assert os.path.basename(so).startswith("libdiffmpc_kernels-")
    assert build.build() == (so, "")  # built once


UNIQUE_CACHE = r"""
template <int N> int& counter() { static int c = N; return c; }
extern "C" int bump() { return ++counter<1>(); }
"""


@pytest.mark.parametrize("linkage", ["template", "unnamed namespace"])
def test_unique_symbols_finds_a_template_static(tmp_path, linkage):
    """build.unique_symbols reads the GNU unique symbols a library exports:
    a template's function-local static is one (shared by every library of
    the process), the same static in an unnamed namespace is none."""
    gxx = shutil.which("g++")
    if gxx is None or shutil.which("nm") is None:
        pytest.skip("g++ and nm build and read the library")
    text = UNIQUE_CACHE if linkage == "template" else UNIQUE_CACHE.replace(
        "template <int N> int& counter() { static int c = N; return c; }",
        "namespace { template <int N> int& counter() { static int c = N; return c; } }")
    (tmp_path / "u.cpp").write_text(text)
    so = tmp_path / "libu.so"
    proc = subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-o", str(so), str(tmp_path / "u.cpp")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert build.unique_symbols(str(so)) == (["_ZZ7counterILi1EERivE1c"] if linkage == "template" else [])


@pytest.mark.parametrize("L", [1, 2, 3, 8, 16, 1000, 1027])
def test_host_build_shard_probe_matches_plain(host_lib, L):
    """Three float32 adds in the body's order, the shard's clamp included:
    bit-equal, for one thread and for a grid of 32 and of three blocks of
    32 threads (each thread its share of the head, tail and groups of four),
    into an aligned ``out`` and into views at each offset of 1-3 floats."""
    fn = host_lib.diffmpc_shard_probe_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    x = torch.tensor(np.random.default_rng(L).normal(size=L), dtype=torch.float32)
    want = shard_probe_plain(x)
    for threads in (1, 32, 96):
        for offset in (0, 1, 2, 3):
            base = torch.full((L + 8,), float("nan"))
            out = base[offset:offset + L]
            assert fn(x.data_ptr(), out.data_ptr(), L, threads) == 0
            assert torch.equal(out, want), (threads, offset)
            assert torch.isnan(base[:offset]).all() and torch.isnan(base[offset + L:]).all(), (threads, offset)


# ---------------------------------------------------------------------------
# The variants' headers (SHIM_VARIANTS): the box QP's enumeration modes, the
# simplified value update and pnqp_iter, at the (6, 3) shape of the slice.
# ---------------------------------------------------------------------------


def _riccati_enum_launcher(host_lib, enum, stream):
    fn = host_lib.diffmpc_riccati_enum_host
    fn.argtypes = [ctypes.POINTER(_RiccatiArgs)] + [ctypes.c_int] * 4
    fn.restype = ctypes.c_int

    def launch(args, n, m, mode):
        assert mode == 1 and fn(args, n, m, enum, stream) == 0, f"no host instantiation for n={n}, m={m}"

    return launch


@pytest.mark.parametrize("n,m,mode,enum", [(6, 3, "", 0), (6, 3, "1", 2), (4, 2, "0", 1)])
def test_host_build_riccati_enum_modes_equal_one_lane_and_match_plain(host_lib, n, m, mode, enum):
    """The box QP under each mode that changes it (the loop at (6, 3) and,
    under "0", at (4, 2); the 27 candidates at (6, 3) under "1", shared out
    over a group's lanes): one lane within the plain version's rule, every
    lane count bit-equal to one lane, and the twin's too under "1"."""
    args, kw = _riccati_lane_case(n, m, "box", True, 1620 + 10 * n + enum, T=5, B=24)
    kw["pnqp_enum"] = mode
    launch = _riccati_enum_launcher(host_lib, enum, 0)
    one = run_staged_riccati(launch, *args, **kw)
    want = riccati_backward_plain(*args, **kw)
    _assert_riccati_matches(one, want)
    assert not bool(one.free_mask.all())
    assert bool((one.n_qp_iter == 1).all()) == (mode == "1")
    launches = (launch, _riccati_enum_launcher(host_lib, enum, 1)) if mode == "1" else (launch,)
    _riccati_every_lane_count(launches, args, kw, one)


def _nn63_problem(seed, B=12, T=5):
    """scripts/ab_pnqp_enum3.py's problem at a small size: a residual
    6-16-16-6 MLP, C = diag(1 x 6, 0.02 x 3), c = (0 x 6, 0.08 x 3), box
    +-0.5, x0 ~ U(-0.8, 0.8)."""
    gen = torch.Generator().manual_seed(seed)
    nn = NNDynamics.init(6, 3, hidden=(16, 16), residual=True, device="cpu", generator=gen)
    C = torch.diag(torch.tensor([1.0] * 6 + [0.02] * 3)).expand(T, B, 9, 9)
    c = torch.tensor([0.0] * 6 + [0.08] * 3).expand(T, B, 9)
    x0 = torch.rand((B, 6), generator=gen) * 1.6 - 0.8
    box = torch.full((T, B, 3), 0.5)
    return x0, C, c, nn, -box, box


@pytest.mark.parametrize("mode,symbol", [("", "diffmpc_ilqr_solve_n6m3_h16x16_host"),
                                         ("1", "diffmpc_ilqr_solve_n6m3_h16x16_enum3_host")])
def test_host_build_mlp_63_solve_modes_match_plain(host_lib, mode, symbol):
    """The (6, 3) MLP of DMPC_HIDDEN "16x16" in the fused solve (the variant
    build's shared sweep): one iteration within the plain version's 1e-4
    (objectives relative to their scale), every built lane count bit-equal
    to one over two iterations, cold and warm-started; under the loop,
    ``pnqp_iter`` is the args' (2 steps part from 8 in both)."""
    args = _nn63_problem(1640)
    launch = _nn_launcher(host_lib, symbol)
    knobs = dict(lqr_iter=1, eps=0.0, pnqp_enum=mode)
    one = run_staged(launch, *args, **{k: v for k, v in knobs.items() if k != "pnqp_enum"})
    want = ilqr_solve_plain(*args, **knobs)
    scale = max(1.0, float(want.objs.abs().max()))
    for name, g, w in zip(one._fields, one, want):
        tol = 1e-4 * (scale if name in ("objs", "last_improvement") else 1.0)
        np.testing.assert_allclose(g.double().numpy(), w.double().numpy(), atol=tol, rtol=0, err_msg=name)
    for u_init in (None, torch.cat([one.us[1:], one.us[-1:]], 0)):
        ref = run_staged(launch, *args, u_init=u_init, lqr_iter=2, eps=0.0)
        for lanes in ILQR_LANES[1:]:
            _assert_equal_results(run_staged(launch, *args, u_init=u_init, lanes=lanes, lqr_iter=2, eps=0.0), ref)
    if mode == "":
        two = run_staged(launch, *args, lqr_iter=1, eps=0.0, pnqp_iter=2)
        plain_two = ilqr_solve_plain(*args, lqr_iter=1, eps=0.0, pnqp_iter=2)
        np.testing.assert_allclose(two.us.numpy(), plain_two.us.numpy(), atol=1e-4, rtol=0)
        np.testing.assert_array_equal(two.qp_iters.numpy(), plain_two.qp_iters.numpy())
        assert not torch.equal(two.qp_iters, one.qp_iters)
    else:
        assert bool((one.qp_iters == 1).all())


def test_host_build_pendulum_simplified_update_matches_plain(host_lib):
    """The fused solve's EXACT body (the m = 1 closed form is exact) against
    the plain version with ``value_update_exact_reg=1e-6``: one iteration
    within 1e-4, four by the chaos rule; 16 lanes bit-equal to one."""
    launch = _ilqr_launcher(host_lib, "diffmpc_ilqr_solve_pendulum_exact_host", _PendulumEnv)
    t, dx = torch_inputs(make_problem(seed=1660, warm=True))
    args = (t["x_init"], t["C"], t["c"], dx, t["u_lower"], t["u_upper"])
    for knobs, rule in ((dict(lqr_iter=1, eps=0.0), assert_tight), (dict(lqr_iter=4, eps=1e-5), assert_chaos)):
        one = run_staged(launch, *args, u_init=t["u_init"], **knobs)
        rule(as_numpy(one), as_numpy(ilqr_solve_plain(*args, u_init=t["u_init"], value_update_exact_reg=1e-6,
                                                       **knobs)))
        _assert_equal_results(run_staged(launch, *args, u_init=t["u_init"], lanes=16, **knobs), one)


@pytest.mark.parametrize("exact", [False, True], ids=["full", "simplified"])
@pytest.mark.parametrize("n,m", [(6, 3), (3, 1)])
def test_host_build_kkt_variants_match_plain_and_twin(host_lib, n, m, exact):
    """The KKT backward at (6, 3) and (3, 1), full or simplified value update,
    within 1e-5 of the plain version with the same ``value_update_exact_reg``;
    the twin bit-equal to the resident kernel."""
    fn = host_lib.diffmpc_kkt_variant_host
    fn.argtypes = [ctypes.POINTER(_KktArgs)] + [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    res = random_residuals(np.random.default_rng(1670 + n + exact), 7, 19, n, m, 20)
    ins = [torch.tensor(a) for a in kernel_inputs(res)]
    reg = 1e-7
    outs = []
    for stream in (0, 1):
        def launch(args, n_, m_, stream=stream):
            assert fn(args, n_, m_, int(exact), stream) == 0
        outs.append(run_staged_kkt(launch, *ins, reg=reg))
    want = kkt_backward_plain(*ins, reg=reg, value_update_exact_reg=1e-6 if exact else -1.0)
    for name, g, w in zip(("dx_init", "dC", "dc", "dF", "df"), outs[0], want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=1e-5, err_msg=name)
    _assert_equal_results(outs[1], outs[0])
    if exact:
        assert not torch.equal(outs[0][0], kkt_backward_plain(*ins, reg=reg)[0])


@pytest.mark.parametrize("stream", [False, True], ids=["direct", "staged"])
def test_host_build_rollout_63_lanes_equal_one_lane_and_match_plain(host_lib, stream):
    """The line search at (6, 3) with a box: one lane within the rollout
    tolerances of the plain version, every built lane count bit-equal to it."""
    rng = np.random.default_rng(1680)
    T, B, n, m = 6, 29, 6, 3
    C, c, F, f, x0 = (torch.tensor(a, dtype=torch.float32) for a in random_lqr_problem(rng, T, B, n, m))
    u_hat = torch.tensor(rng.uniform(-0.3, 0.3, (T, B, m)), dtype=torch.float32)
    x_hat, _ = lqr_rollout(x0, F, f, torch.zeros(T, B, m, n), torch.zeros(T, B, m), u_hat=u_hat)
    K = torch.tensor(rng.normal(size=(T, B, m, n)) * 0.3, dtype=torch.float32)
    k = torch.tensor(rng.normal(size=(T, B, m)) * rng.uniform(0.5, 8.0, (1, B, 1)), dtype=torch.float32)
    args = (x0, C, c, F, f, K, k, x_hat, u_hat)
    kw = dict(u_lower=torch.tensor(-0.7), u_upper=torch.full((T, B, m), 0.7), decay=0.5, max_iter=10)
    fn = host_lib.diffmpc_rollout_n6m3_host
    fn.argtypes = [ctypes.POINTER(_RolloutArgs), ctypes.c_int]
    fn.restype = ctypes.c_int

    def launcher(staged):
        def launch(a, n_, m_, env):
            assert env is None and fn(a, int(staged)) == 0, "refused"

        return launch

    one = run_staged_rollout(launcher(False), *args, **kw)
    _assert_rollout_matches(one, linesearch_rollout_plain(*args, **kw))
    assert len(np.unique(one.alpha.numpy())) > 1
    for lanes in ROLLOUT_LANES:
        _assert_equal_results(run_staged_rollout(launcher(stream), *args, lanes=lanes, **kw), one)


# ---------------------------------------------------------------------------
# The dynamics zoo's C++ steps (csrc/<env>.cuh), built through variant.cuh's
# DMPC_ENV as the card builds them (SHIM_ZOO), and dual.cuh's operators.
# ---------------------------------------------------------------------------


def test_host_build_dual_mixed_operators_match_their_formulas(host_lib):
    """``Dual - T``, ``T - Dual`` and ``T / Dual`` (the cartpole's
    ``4/3 - m_pole cos^2 / M`` among them) at ``Dual<float, 4>``: values
    equal to float's, bit for bit, and tangents the formulas' (d(a - s) = da,
    d(s - a) = -da, d(s / a) = -(s / a) da / a) within float32 rounding;
    ``NcFloat`` gives float's values on the host."""
    B = 64
    rng = np.random.default_rng(1400)
    a = rng.uniform(0.5, 2.0, B).astype(np.float32) * rng.choice([-1, 1], B).astype(np.float32)
    da = rng.standard_normal((B, 4)).astype(np.float32)
    s_ = rng.standard_normal(B).astype(np.float32)
    vals, tans = np.zeros((B, 3), np.float32), np.zeros((B, 3, 4), np.float32)
    plain, nc = np.zeros((B, 3), np.float32), np.zeros((B, 3), np.float32)
    ptr = [x.ctypes.data_as(ctypes.c_void_p) for x in (a, da, s_, vals, tans, plain, nc)]
    assert host_lib.diffmpc_dual_mixed_host(B, *ptr) == 0
    np.testing.assert_array_equal(vals, plain)
    np.testing.assert_array_equal(nc, plain)
    np.testing.assert_array_equal(plain[:, 0], a - s_)
    np.testing.assert_array_equal(plain[:, 1], s_ - a)
    np.testing.assert_array_equal(plain[:, 2], s_ / a)
    a64, da64, s64 = a.astype(np.float64), da.astype(np.float64), s_.astype(np.float64)
    np.testing.assert_array_equal(tans[:, 0], da)
    np.testing.assert_array_equal(tans[:, 1], -da)
    np.testing.assert_allclose(tans[:, 2], -(s64 / a64)[:, None] * da64 / a64[:, None], rtol=1e-6, atol=1e-7)


ZOO_HOST_CASES = ["cartpole", "cartpole_per_scenario", "vehicle", "quadrotor", "acrobot"]


def _zoo_launcher(host_lib, name):
    struct = type(ilqr_mod.kernel_env(port_model(name, torch.float32)).struct)
    return _ilqr_launcher(host_lib, f"diffmpc_ilqr_solve_host_{name}", struct)


@pytest.mark.parametrize("case", ZOO_HOST_CASES)
def test_host_build_zoo_solve_matches_plain_and_equals_one_lane(host_lib, case):
    """Each env's C++ step in the fused solve with the variant build's sweep
    (variant.cuh's kVariantSharedSweep: the lanes share each step's Riccati
    arithmetic and linearize in rounds) (B=8, the golden's starts, cost and
    box, T=10): one iteration within 1e-4 of the plain version with
    ``n_iters`` equal; every built lane count bit-equal to one lane over
    three iterations (the ladder's decay 0.8, so that the picks spread),
    cold and warm-started from the cold solve's controls shifted one step."""
    name = case.split("_")[0]
    args = kernel_problem(name, 8, 10, torch.float32, per_scenario=case.endswith("scenario"), seed=1401)
    launch = _zoo_launcher(host_lib, name)
    first = dict(lqr_iter=1, eps=0.0)
    assert_tight(as_numpy(run_staged(launch, *args, **first)), as_numpy(ilqr_solve_plain(*args, **first)))
    three = dict(lqr_iter=3, eps=1e-5, decay=0.8)
    cold = run_staged(launch, *args, **three)
    for u_init in (None, torch.cat([cold.us[1:], cold.us[-1:]], 0)):
        one = run_staged(launch, *args, u_init=u_init, **three)
        for lanes in ILQR_LANES[1:]:
            _assert_equal_results(run_staged(launch, *args, u_init=u_init, lanes=lanes, **three), one)


def _tie_problem(B=5):
    """The fused solve at T=1 from x = 0, cold, on the vehicle's step (m = 2:
    the box QP's nine candidates): V is zero, so the step's Quu and qu are C's
    and c's control blocks, those of the Riccati tie test below (the clipped
    Newton point (1, -1) and candidate 1, (63/64, -1), tie in float32
    objective), box +-1."""
    n, m, T = 4, 2, 1
    C = np.zeros((T, B, n + m, n + m), np.float32)
    C[..., :n, :n] = np.eye(n, dtype=np.float32)
    C[..., n:, n:] = [[4.0, 1.0], [1.0, 4.0]]
    c = np.zeros((T, B, n + m), np.float32)
    c[..., n:] = [-2.9375, 16384.0]
    box = torch.ones(T, B, m)
    return torch.zeros(B, n), torch.tensor(C), torch.tensor(c), port_model("vehicle", torch.float32), -box, box


def test_host_build_shared_sweep_keeps_the_earlier_of_tied_candidates(host_lib):
    """A box-QP tie in the fused solve's shared sweep (the vehicle's variant
    build, T=1): every lane count keeps the clipped Newton point, candidate
    0, as the enumeration's strict "<" does, so the first ladder step
    applies (1, -1) on every scenario, as in the plain version."""
    assert _f32_qp_obj([[4.0, 1.0], [1.0, 4.0]], [-2.9375, 16384.0], (1.0, -1.0)) == _f32_qp_obj(
        [[4.0, 1.0], [1.0, 4.0]], [-2.9375, 16384.0], (63 / 64, -1.0))
    args = _tie_problem()
    launch = _zoo_launcher(host_lib, "vehicle")
    one = run_staged(launch, *args, lqr_iter=1, eps=0.0)
    assert one.us.tolist() == [[[1.0, -1.0]] * 5] and bool((one.alpha == 1.0).all())
    _assert_equal_results(ilqr_solve_plain(*args, lqr_iter=1, eps=0.0), one)
    for lanes in ILQR_LANES[1:]:
        _assert_equal_results(run_staged(launch, *args, lanes=lanes, lqr_iter=1, eps=0.0), one)


def test_host_build_shared_sweep_keeps_a_nan_to_its_scenario(host_lib):
    """A NaN in one step's C of one scenario of the vehicle's fused solve
    (its variant build's shared sweep, B=8, T=10, three iterations): that
    scenario's objective is NaN, every other scenario equals the solve
    without the NaN bit for bit, and every lane count equals one lane, NaN
    positions included."""
    args = kernel_problem("vehicle", 8, 10, torch.float32, seed=1405)
    launch = _zoo_launcher(host_lib, "vehicle")
    three = dict(lqr_iter=3, eps=1e-5, decay=0.8)
    clean = run_staged(launch, *args, **three)
    C = args[1].clone()
    C[3, 5, 1, 4] = C[3, 5, 4, 1] = float("nan")
    args = (args[0], C) + args[2:]
    one = run_staged(launch, *args, **three)
    assert bool(torch.isnan(one.objs[5])) and not bool(torch.isnan(one.objs[torch.arange(8) != 5]).any())
    others = torch.arange(8) != 5
    for name, g, w in zip(one._fields, one, clean):
        axis = 1 if g.ndim == 3 else 0
        np.testing.assert_array_equal(g.index_select(axis, others.nonzero()[:, 0]).numpy(),
                                      w.index_select(axis, others.nonzero()[:, 0]).numpy(), err_msg=name)
    for lanes in ILQR_LANES[1:]:
        _assert_equal_results(run_staged(launch, *args, lanes=lanes, **three), one)


def test_host_build_prebuilt_pendulum_keeps_its_sweep(host_lib, host_launch):
    """The prebuilt fused kernels keep the sweep every lane repeats
    (ilqr.cuh's riccati_sweep) and their flags: only the variant build
    (csrc/variants/) names the shared sweep's selector, and only its fused
    solve is built without FMA contraction. The pendulum's prebuilt host
    build and its build as a variant (the shared sweep) each hold one
    iteration within 1e-4 of the plain version with ``n_iters`` equal, and
    four iterations within the chaos rule."""
    for name in ("ilqr.cu", "ilqr_nn.cu", *(f"ilqr_nn_l{L}.cu" for L in ILQR_LANES)):
        path = os.path.join(build.CSRC, name)
        with open(path) as f:
            assert "SharedSweep" not in f.read(), name
        assert build.source_flags(path) == (), name
    with open(os.path.join(build.VARIANTS, "variant.cuh")) as f:
        assert "constexpr bool kVariantSharedSweep" in f.read()
    for unit in build.variant_units(build.VariantKey("ilqr", 5, 1, "cartpole")):
        assert "-fmad=false" in unit
    variant = _ilqr_launcher(host_lib, "diffmpc_ilqr_solve_pendulum_variant_host", _PendulumEnv)
    t, dx = torch_inputs(make_problem(seed=1406, warm=True))
    args = (t["x_init"], t["C"], t["c"], dx, t["u_lower"], t["u_upper"])
    for knobs, rule in ((dict(lqr_iter=1, eps=0.0), assert_tight), (dict(lqr_iter=4, eps=1e-5), assert_chaos)):
        plain = as_numpy(ilqr_solve_plain(*args, u_init=t["u_init"], **knobs))
        for launch in (host_launch, variant):
            rule(as_numpy(run_staged(launch, *args, u_init=t["u_init"], **knobs)), plain)


@pytest.mark.parametrize("env", ["pendulum", *ZOO_KEYS])
def test_host_build_one_robot_solve_matches_plain_and_equals_one_lane(host_lib, host_launch, env):
    """One scenario (B=1, the render example's problem): one iteration
    within 1e-4 of the plain version with ``n_iters`` equal; every built
    lane count bit-equal to one lane over the example's eight iterations,
    cold and warm-started from the cold solve's controls shifted one step
    (the receding loop's warm start)."""
    args = one_robot_problem(env, "cpu")
    launch = host_launch if env == "pendulum" else _zoo_launcher(host_lib, env)
    first = dict(lqr_iter=1, eps=0.0)
    assert_tight(as_numpy(run_staged(launch, *args, **first)), as_numpy(ilqr_solve_plain(*args, **first)))
    eight = dict(lqr_iter=8, eps=1e-5)
    cold = run_staged(launch, *args, **eight)
    warm = torch.cat([cold.us[1:], cold.us[-1:]], 0)
    for u_init in (None, warm):
        one = run_staged(launch, *args, u_init=u_init, **eight)
        for lanes in ILQR_LANES[1:]:
            _assert_equal_results(run_staged(launch, *args, u_init=u_init, lanes=lanes, **eight), one)


@pytest.mark.parametrize("name", ZOO)
def test_host_build_zoo_line_search_matches_plain_and_equals_one_lane(host_lib, name):
    """Each env's C++ step in the line search (B=8, T=10): the non-fused
    loop's inputs (a rollout of random controls in the box, the box sweep's
    gains about it, the feedforward scaled by up to 8), the resident
    kernel's host build against the plain version (the rollout tolerances
    above), and every built lane count of it and of the twin bit-equal to
    one lane."""
    args, kw = _zoo_line_search_inputs(name)
    launcher = _zoo_rollout_launcher(host_lib, name, kw["dyn"])
    got = run_staged_rollout(launcher(0), *args, **kw)
    _assert_rollout_matches(got, linesearch_rollout_plain(*args, **kw))
    for stream in (0, 1):
        for lanes in ROLLOUT_LANES:
            _assert_equal_results(run_staged_rollout(launcher(stream), *args, lanes=lanes, **kw), got)


def _zoo_line_search_inputs(name: str, B: int = 8, T: int = 10):
    """The line search's inputs of the non-fused loop for env ``name``: a
    rollout of random controls in the box, the box sweep's gains about it,
    the feedforward scaled by up to 8."""
    x0, C, c, dyn, lo, hi = kernel_problem(name, B, T, torch.float32, seed=1402)
    n = dyn.n_state
    gen = torch.Generator().manual_seed(1403)
    u_hat = lo + (hi - lo) * torch.rand(lo.shape, generator=gen)
    xs = [x0]
    for t in range(T - 1):
        xs.append(dyn.forward(xs[-1], u_hat[t]))
    x_hat = torch.stack(xs)
    F, _ = linearize_dynamics(dyn, x_hat, u_hat)
    gains = riccati_backward_plain(C, c + bmv(C, torch.cat([x_hat, u_hat], -1)), F, None, n, u_lower=lo, u_upper=hi,
                                   u_hat=u_hat)
    k = gains.k * (0.5 + 7.5 * torch.rand((1, B, 1), generator=gen))
    return (x0, C, c, None, None, gains.K, k, x_hat, u_hat), dict(u_lower=lo, u_upper=hi, dyn=dyn)


def _zoo_rollout_launcher(host_lib, symbol: str, dyn):
    """``launcher(stream)``: the host build's line search ``symbol`` (the
    resident kernel, or with ``stream`` the twin) for ``run_staged_rollout``."""
    fn = getattr(host_lib, f"diffmpc_rollout_host_{symbol}")
    fn.argtypes = [ctypes.POINTER(_RolloutArgs), ctypes.POINTER(type(ilqr_mod.kernel_env(dyn).struct)), ctypes.c_int]
    fn.restype = ctypes.c_int

    def launcher(stream):
        def launch(args, n, m, env):
            assert fn(args, env, stream) == 0

        return launch

    return launcher


def test_host_build_other_cheap_step_equals_the_headers_build(host_lib):
    """The acrobot built with the other ``kCheapStep``
    (``DMPC_FLIP_CHEAP_STEP=1``, the build that
    ``diagnostics/ab_cheap_step.py`` times beside the headers'): its fused
    solve refuses lane scratch sized by the headers' rule at 2 lanes (the
    flag took), and with scratch sized for it (``ab_cheap_step.flipped``)
    every built lane count of its fused solve, its line search and the twin
    is bit-equal to the headers' build at one lane (the scratch sized so
    under nested ``flipped`` too)."""
    from diffmpc_tpu_torch.diagnostics import ab_cheap_step

    args = kernel_problem("acrobot", 8, 10, torch.float32, seed=1404)
    three = dict(lqr_iter=3, eps=1e-5, decay=0.8)
    one = run_staged(_zoo_launcher(host_lib, "acrobot"), *args, **three)
    struct = type(ilqr_mod.kernel_env(args[3]).struct)
    fn = host_lib.diffmpc_ilqr_solve_host_acrobot_flipped
    fn.argtypes = [ctypes.POINTER(_IlqrArgs), ctypes.POINTER(struct)]
    fn.restype = ctypes.c_int
    refused = []
    run_staged(lambda a, env: refused.append(fn(a, env)), *args, lanes=2, **three)
    assert refused == [1]
    flipped = _ilqr_launcher(host_lib, "diffmpc_ilqr_solve_host_acrobot_flipped", struct)
    with ab_cheap_step.flipped({}), ab_cheap_step.flipped({}):  # nested, as the diagnostic's stages nest
        for lanes in ILQR_LANES:
            _assert_equal_results(run_staged(flipped, *args, lanes=lanes, **three), one)
    ls_args, kw = _zoo_line_search_inputs("acrobot")
    got = run_staged_rollout(_zoo_rollout_launcher(host_lib, "acrobot", kw["dyn"])(0), *ls_args, **kw)
    launcher = _zoo_rollout_launcher(host_lib, "acrobot_flipped", kw["dyn"])
    for stream in (0, 1):
        for lanes in ROLLOUT_LANES:
            _assert_equal_results(run_staged_rollout(launcher(stream), *ls_args, lanes=lanes, **kw), got)
