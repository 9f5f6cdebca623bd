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
// Per step t = T-1..0, with the value carry (V, v) in registers:
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

template <int N, int M, int MODE>
DMPC_HD void riccati_backward_scenario(const RiccatiArgs& a, int b) {
  using riccati_detail::at;
  constexpr int NM = N + M;
  const int T = a.T, B = a.B;
  float V[N][N], v[N];
  for (int i = 0; i < N; ++i) {
    v[i] = 0.0f;
    for (int j = 0; j < N; ++j) V[i][j] = 0.0f;
  }
  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    float Ft[N][NM];
    for (int i = 0; i < N; ++i)
      for (int j = 0; j < NM; ++j) Ft[i][j] = a.F[at(t, i * NM + j, N * NM, B, b)];
    // W = V F ; z = V f + v
    float W[N][NM], z[N];
    for (int k = 0; k < N; ++k) {
      for (int j = 0; j < NM; ++j) {
        float s2 = 0.0f;
        for (int l = 0; l < N; ++l) s2 += V[k][l] * Ft[l][j];
        W[k][j] = s2;
      }
      float s2 = 0.0f;
      if (a.f)
        for (int l = 0; l < N; ++l) s2 += V[k][l] * a.f[at(t, l, N, B, b)];
      z[k] = s2 + v[k];
    }
    // Q = C + F'W (upper triangle of C, mirrored) ; q = c + F'z
    float Q[NM][NM], q[NM];
    for (int i = 0; i < NM; ++i)
      for (int j = i; j < NM; ++j) {
        float s2 = 0.0f;
        for (int k = 0; k < N; ++k) s2 += Ft[k][i] * W[k][j];
        Q[i][j] = a.C[at(t, i * NM + j, NM * NM, B, b)] + s2;
        Q[j][i] = Q[i][j];
      }
    for (int i = 0; i < NM; ++i) {
      float s2 = 0.0f;
      for (int k = 0; k < N; ++k) s2 += Ft[k][i] * z[k];
      q[i] = a.c[at(t, i, NM, B, b)] + s2;
    }
    float Quu[M][M], qu[M], cols[N][M];
    for (int i = 0; i < M; ++i) {
      for (int j = 0; j < M; ++j) Quu[i][j] = Q[N + i][N + j];
      qu[i] = q[N + i];
      for (int j = 0; j < N; ++j) cols[j][i] = Q[N + i][j];  // column j of Qux
    }
    float K[M][N], kt[M], frozen[M];
    if constexpr (MODE == kRiccatiBox) {
      float lo[M], hi[M], Kc[N][M];
      for (int i = 0; i < M; ++i) {
        lo[i] = a.lo[at(t, i, M, B, b)];
        hi[i] = a.hi[at(t, i, M, B, b)];
      }
      a.n_qp[(size_t)t * B + b] = pnqp_entries<M>(Quu, qu, lo, hi, a.pnqp_iter, a.reg, kt, frozen);
      masked_chol_solve<M, N>(Quu, cols, frozen, a.reg, Kc);
      for (int i = 0; i < M; ++i)
        for (int j = 0; j < N; ++j) K[i][j] = -Kc[j][i];
    } else if constexpr (MODE == kRiccatiMask) {
      float rhs[N + 1][M], sol[N + 1][M];  // the columns of Qux, then qu
      for (int i = 0; i < M; ++i) {
        frozen[i] = a.mask[at(t, i, M, B, b)];
        for (int j = 0; j < N; ++j) rhs[j][i] = cols[j][i];
        rhs[N][i] = qu[i];
      }
      masked_chol_solve<M, N + 1>(Quu, rhs, frozen, a.reg, sol);
      for (int i = 0; i < M; ++i) {
        for (int j = 0; j < N; ++j) K[i][j] = -sol[j][i];
        kt[i] = -sol[N][i];
      }
    } else {
      float L[M][M], col[M];
      chol_entries<M>(Quu, a.reg, L);
      for (int j = 0; j < N; ++j) {
        cho_solve_entries<M>(L, cols[j], col);
        for (int i = 0; i < M; ++i) K[i][j] = -col[i];
      }
      cho_solve_entries<M>(L, qu, col);
      for (int i = 0; i < M; ++i) {
        kt[i] = -col[i];
        frozen[i] = 0.0f;
      }
    }
    for (int i = 0; i < M; ++i) {
      for (int j = 0; j < N; ++j) a.K[at(t, i * N + j, M * N, B, b)] = K[i][j];
      a.k[at(t, i, M, B, b)] = kt[i];
      a.free[at(t, i, M, B, b)] = 1.0f - frozen[i];
    }
    value_update<N, M>(Q, q, Quu, qu, K, kt, V, v);
  }
}
