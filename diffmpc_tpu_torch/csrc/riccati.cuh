// The Riccati backward sweep of ONE scenario, in three modes.
//
// Counterpart of the TPU kernel body _make_kernel in
// diffmpc_tpu/ops/pallas/riccati.py (:521-613), computing what it computes
// with one thread in place of one lane of an (S, 128) tile. csrc/riccati.cu
// runs it on the card with one thread per scenario; the tests build it with
// g++ for the host. diffmpc_tpu_torch/ops/cuda/riccati.py
// (riccati_backward_plain) is the same algorithm in plain PyTorch,
// vectorised over the batch.
//
// Per step t = T-1..0, with the value carry (V, v) in registers
// (riccati_step, which reads the step's inputs through an accessor: device
// memory here, a shared-memory slot in the streaming twin riccati_stream.cuh):
//   W = V F, z = V f + v, Q = C + F'W (upper triangle, mirrored), q = c + F'z;
//   free: [K k] = -(Quu + reg)^-1 [Qux qu];
//   box:  k from the box QP on [lo_t, hi_t], K from the masked solve with
//         the clamped dims frozen;
//   mask: [K k] from the masked solve with the given dims frozen;
//   then the full-form value update.
//
// Layout: every per-step array is batch-minor, (T, entries..., B), so that
// neighbouring threads touch neighbouring addresses.
#pragma once

#include "dual.cuh"
#include "riccati_entries.cuh"

enum RiccatiMode { kRiccatiFree = 0, kRiccatiBox = 1, kRiccatiMask = 2 };

// Launch arguments. The field order is mirrored by ctypes in
// diffmpc_tpu_torch/ops/cuda/riccati.py (_RiccatiArgs): keep the two in step.
struct RiccatiArgs {
  // inputs
  const float* C;     // (T, NM, NM, B)
  const float* c;     // (T, NM, B)
  const float* F;     // (T, N, NM, B)
  const float* f;     // (T, N, B), or null for zeros
  const float* lo;    // (T, M, B) box mode: u_lower - u_hat
  const float* hi;    // (T, M, B) box mode: u_upper - u_hat
  const float* mask;  // (T, M, B) mask mode: 1.0 where the control is frozen
  // outputs
  float* K;     // (T, M, N, B)
  float* k;     // (T, M, B)
  float* free;  // (T, M, B) 1.0 where the control is free
  float* n_qp;  // (T, B) box mode: box-QP solves
  int T;
  int B;
  int pnqp_iter;
  float reg;
};

namespace riccati_detail {

// element (t, i) of a batch-minor (T, D, B) array, for scenario b
DMPC_HD size_t at(int t, int i, int D, int B, int b) {
  return ((size_t)t * D + i) * (size_t)B + b;
}

}  // namespace riccati_detail

// Step t's inputs for scenario b, read from the args' device memory. An
// accessor gives C(i, j) for j >= i, c(i), F(i, j), has_f() and f(i), lo(i),
// hi(i) (box mode) and mask(i) (mask mode).
template <int N, int M>
struct RiccatiGlobal {
  static constexpr int NM = N + M;
  const RiccatiArgs& a;
  int t;
  int b;
  DMPC_HD float C(int i, int j) const { return a.C[riccati_detail::at(t, i * NM + j, NM * NM, a.B, b)]; }
  DMPC_HD float c(int i) const { return a.c[riccati_detail::at(t, i, NM, a.B, b)]; }
  DMPC_HD float F(int i, int j) const { return a.F[riccati_detail::at(t, i * NM + j, N * NM, a.B, b)]; }
  DMPC_HD bool has_f() const { return a.f != nullptr; }
  DMPC_HD float f(int i) const { return a.f[riccati_detail::at(t, i, N, a.B, b)]; }
  DMPC_HD float lo(int i) const { return a.lo[riccati_detail::at(t, i, M, a.B, b)]; }
  DMPC_HD float hi(int i) const { return a.hi[riccati_detail::at(t, i, M, a.B, b)]; }
  DMPC_HD float mask(int i) const { return a.mask[riccati_detail::at(t, i, M, a.B, b)]; }
};

// The step's quadratic model from its inputs `in` and the next value (V, v):
// W = V F, z = V f + v, Q = C + F'W (upper triangle, mirrored), q = c + F'z.
template <int N, int M, class In>
DMPC_HD void riccati_q_form(const In& in, const float (&V)[N][N], const float (&v)[N], float (&Q)[N + M][N + M],
                            float (&q)[N + M]) {
  constexpr int NM = N + M;
  float Ft[N][NM];
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < NM; ++j) Ft[i][j] = in.F(i, j);
  // W = V F ; z = V f + v
  float W[N][NM], z[N];
  for (int k = 0; k < N; ++k) {
    for (int j = 0; j < NM; ++j) {
      float s2 = 0.0f;
      for (int l = 0; l < N; ++l) s2 += V[k][l] * Ft[l][j];
      W[k][j] = s2;
    }
    float s2 = 0.0f;
    if (in.has_f())
      for (int l = 0; l < N; ++l) s2 += V[k][l] * in.f(l);
    z[k] = s2 + v[k];
  }
  // Q = C + F'W (upper triangle of C, mirrored) ; q = c + F'z
  for (int i = 0; i < NM; ++i)
    for (int j = i; j < NM; ++j) {
      float s2 = 0.0f;
      for (int k = 0; k < N; ++k) s2 += Ft[k][i] * W[k][j];
      Q[i][j] = in.C(i, j) + s2;
      Q[j][i] = Q[i][j];
    }
  for (int i = 0; i < NM; ++i) {
    float s2 = 0.0f;
    for (int k = 0; k < N; ++k) s2 += Ft[k][i] * z[k];
    q[i] = in.c(i) + s2;
  }
}

// The control blocks of (Q, q): Quu, qu and the columns of Qux.
template <int N, int M>
DMPC_HD void riccati_control_blocks(const float (&Q)[N + M][N + M], const float (&q)[N + M], float (&Quu)[M][M],
                                    float (&qu)[M], float (&cols)[N][M]) {
  for (int i = 0; i < M; ++i) {
    for (int j = 0; j < M; ++j) Quu[i][j] = Q[N + i][N + j];
    qu[i] = q[N + i];
    for (int j = 0; j < N; ++j) cols[j][i] = Q[N + i][j];  // column j of Qux
  }
}

// Free-mode gains: [K k] = -(Quu + reg)^-1 [Qux qu].
template <int N, int M>
DMPC_HD void riccati_free_gains(const float (&Quu)[M][M], const float (&qu)[M], const float (&cols)[N][M], float reg,
                                float (&K)[M][N], float (&kt)[M]) {
  float L[M][M], col[M];
  chol_entries<M>(Quu, reg, L);
  for (int j = 0; j < N; ++j) {
    cho_solve_entries<M>(L, cols[j], col);
    for (int i = 0; i < M; ++i) K[i][j] = -col[i];
  }
  cho_solve_entries<M>(L, qu, col);
  for (int i = 0; i < M; ++i) kt[i] = -col[i];
}

// A free-mode step without its value update: the gains at this step from its
// inputs and the next value (V, v). The depth-blocked sweep
// (riccati_blocked.cuh) recovers its gains with it.
template <int N, int M, class In>
DMPC_HD void riccati_gains_free(const In& in, float reg, const float (&V)[N][N], const float (&v)[N],
                                float (&K)[M][N], float (&kt)[M]) {
  float Q[N + M][N + M], q[N + M], Quu[M][M], qu[M], cols[N][M];
  riccati_q_form<N, M>(in, V, v, Q, q);
  riccati_control_blocks<N, M>(Q, q, Quu, qu, cols);
  riccati_free_gains<N, M>(Quu, qu, cols, reg, K, kt);
}

// One step of the sweep: the gains K, k and the frozen mask at this step from
// its inputs `in` and the value carry (V, v), which it updates in place.
// Returns the box QP's solve count (0 outside box mode).
template <int N, int M, int MODE, class In>
DMPC_HD float riccati_step(const In& in, int pnqp_iter, float reg, float (&V)[N][N], float (&v)[N],
                           float (&K)[M][N], float (&kt)[M], float (&frozen)[M]) {
  constexpr int NM = N + M;
  float Q[NM][NM], q[NM], Quu[M][M], qu[M], cols[N][M];
  riccati_q_form<N, M>(in, V, v, Q, q);
  riccati_control_blocks<N, M>(Q, q, Quu, qu, cols);
  float n_qp = 0.0f;
  if constexpr (MODE == kRiccatiBox) {
    float lo[M], hi[M], Kc[N][M];
    for (int i = 0; i < M; ++i) {
      lo[i] = in.lo(i);
      hi[i] = in.hi(i);
    }
    n_qp = pnqp_entries<M>(Quu, qu, lo, hi, pnqp_iter, reg, kt, frozen);
    masked_chol_solve<M, N>(Quu, cols, frozen, reg, Kc);
    for (int i = 0; i < M; ++i)
      for (int j = 0; j < N; ++j) K[i][j] = -Kc[j][i];
  } else if constexpr (MODE == kRiccatiMask) {
    float rhs[N + 1][M], sol[N + 1][M];  // the columns of Qux, then qu
    for (int i = 0; i < M; ++i) {
      frozen[i] = in.mask(i);
      for (int j = 0; j < N; ++j) rhs[j][i] = cols[j][i];
      rhs[N][i] = qu[i];
    }
    masked_chol_solve<M, N + 1>(Quu, rhs, frozen, reg, sol);
    for (int i = 0; i < M; ++i) {
      for (int j = 0; j < N; ++j) K[i][j] = -sol[j][i];
      kt[i] = -sol[N][i];
    }
  } else {
    riccati_free_gains<N, M>(Quu, qu, cols, reg, K, kt);
    for (int i = 0; i < M; ++i) frozen[i] = 0.0f;
  }
  value_update<N, M>(Q, q, Quu, qu, K, kt, V, v);
  return n_qp;
}

// Write step t's gains, free mask and (box mode) QP count for scenario b.
template <int N, int M, int MODE>
DMPC_HD void riccati_store(const RiccatiArgs& a, int t, int b, const float (&K)[M][N], const float (&kt)[M],
                           const float (&frozen)[M], float n_qp) {
  using riccati_detail::at;
  for (int i = 0; i < M; ++i) {
    for (int j = 0; j < N; ++j) a.K[at(t, i * N + j, M * N, a.B, b)] = K[i][j];
    a.k[at(t, i, M, a.B, b)] = kt[i];
    a.free[at(t, i, M, a.B, b)] = 1.0f - frozen[i];
  }
  if constexpr (MODE == kRiccatiBox) a.n_qp[(size_t)t * a.B + b] = n_qp;
}

template <int N, int M, int MODE>
DMPC_HD void riccati_backward_scenario(const RiccatiArgs& a, int b) {
  float V[N][N], v[N];
  for (int i = 0; i < N; ++i) {
    v[i] = 0.0f;
    for (int j = 0; j < N; ++j) V[i][j] = 0.0f;
  }
  for (int s = 0; s < a.T; ++s) {
    const int t = a.T - 1 - s;
    float K[M][N], kt[M], frozen[M];
    const float n_qp = riccati_step<N, M, MODE>(RiccatiGlobal<N, M>{a, t, b}, a.pnqp_iter, a.reg, V, v, K, kt, frozen);
    riccati_store<N, M, MODE>(a, t, b, K, kt, frozen, n_qp);
  }
}
