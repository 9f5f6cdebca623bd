// The analytic KKT backward of ONE scenario.
//
// Counterpart of the TPU kernel body _make_kernel in
// diffmpc_tpu/ops/pallas/kkt.py (:164-242) and its per-step math
// (_aux_ric_step :71, _diff_roll_step :111, _mult_step :123,
// _cost_grad_entries :141, _dyn_grad_entries :153), computing what it
// computes with one thread in place of one lane of an (S, 128) tile.
// csrc/kkt.cu runs it on the card with one thread per scenario; the tests
// build it with g++ for the host. diffmpc_tpu_torch/ops/cuda/kkt.py
// (kkt_backward_plain) is the same algorithm in plain PyTorch, vectorised
// over the batch. It depends on no env: the dynamics enter as F.
//
// Three sweeps over the horizon:
//   1. the auxiliary Riccati, backward, tight control dims frozen, linear
//      term r; writes the gains K, k;
//   2. the zero-residual differential rollout p, forward from p_x = 0;
//      writes dc = p and dC = 1/2 (p tau' + tau p');
//   3. the multiplier recursions lam (with (tau, c)) and mu (with (p, r)),
//      backward; writes dF = -(mu_{t+1} tau' + lam_{t+1} p'),
//      df = -mu_{t+1} and dx_init = -mu_0.
//
// Layout: every per-step array is batch-minor, (T, entries..., B). The
// value carry and the multipliers live in registers; K, k go through
// global scratch, and sweep 3 reads p back from dc (dc = p).
#pragma once

#include "dual.cuh"
#include "riccati_entries.cuh"

// Launch arguments. The field order is mirrored by ctypes in
// diffmpc_tpu_torch/ops/cuda/kkt.py (_KktArgs): keep the two in step.
struct KktArgs {
  // inputs
  const float* C;      // (T, NM, NM, B)
  const float* c;      // (T, NM, B)
  const float* F;      // (T, N, NM, B)
  const float* r;      // (T, NM, B) incoming gradient, tight dims zeroed
  const float* tau;    // (T, NM, B) primal trajectory [x; u]
  const float* tight;  // (T, M, B) 1.0 where the control is at its bound
  // outputs
  float* dx_init;  // (N, B)
  float* dC;       // (T, NM, NM, B)
  float* dc;       // (T, NM, B); also the differential trajectory p
  float* dF;       // (T, N, NM, B)
  float* df;       // (T, N, B)
  // scratch
  float* K;  // (T, M, N, B) auxiliary feedback gains
  float* k;  // (T, M, B) auxiliary feedforward gains
  int T;
  int B;
  float reg;
};

namespace kkt_detail {

// element (t, i) of a batch-minor (T, D, B) array, for scenario b
DMPC_HD size_t at(int t, int i, int D, int B, int b) {
  return ((size_t)t * D + i) * (size_t)B + b;
}

}  // namespace kkt_detail

template <int N, int M>
DMPC_HD void kkt_backward_scenario(const KktArgs& a, int b) {
  using kkt_detail::at;
  constexpr int NM = N + M;
  const int T = a.T, B = a.B;

  // ---- 1. auxiliary Riccati, tight dims frozen (linear term = r) ----
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
    // W = V F ; Q = C + F'W (upper triangle of C, mirrored) ; q = r + F'v
    float W[N][NM];
    for (int k = 0; k < N; ++k)
      for (int j = 0; j < NM; ++j) {
        float s2 = 0.0f;
        for (int l = 0; l < N; ++l) s2 += V[k][l] * Ft[l][j];
        W[k][j] = s2;
      }
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
      for (int k = 0; k < N; ++k) s2 += Ft[k][i] * v[k];
      q[i] = a.r[at(t, i, NM, B, b)] + s2;
    }
    // one masked solve for the N columns of Qux and the column qu
    float Quu[M][M], qu[M], frozen[M], rhs[N + 1][M], sol[N + 1][M];
    for (int i = 0; i < M; ++i) {
      for (int j = 0; j < M; ++j) Quu[i][j] = Q[N + i][N + j];
      qu[i] = q[N + i];
      frozen[i] = a.tight[at(t, i, M, B, b)];
      for (int j = 0; j < N; ++j) rhs[j][i] = Q[N + i][j];
      rhs[N][i] = qu[i];
    }
    masked_chol_solve<M, N + 1>(Quu, rhs, frozen, a.reg, sol);
    float K[M][N], kt[M];
    for (int i = 0; i < M; ++i) {
      for (int j = 0; j < N; ++j) {
        K[i][j] = -sol[j][i];
        a.K[at(t, i * N + j, M * N, B, b)] = K[i][j];
      }
      kt[i] = -sol[N][i];
      a.k[at(t, i, M, B, b)] = kt[i];
    }
    value_update<N, M>(Q, q, Quu, qu, K, kt, V, v);
  }

  // ---- 2. differential rollout p (f = 0, p_x0 = 0), dC and dc ----
  float px[N];
  for (int i = 0; i < N; ++i) px[i] = 0.0f;
  for (int t = 0; t < T; ++t) {
    float p[NM], tau[NM];
    for (int i = 0; i < N; ++i) p[i] = px[i];
    for (int i = 0; i < M; ++i) {
      float s2 = 0.0f;
      for (int j = 0; j < N; ++j) s2 += a.K[at(t, i * N + j, M * N, B, b)] * px[j];
      p[N + i] = a.k[at(t, i, M, B, b)] + s2;
    }
    for (int i = 0; i < NM; ++i) {
      tau[i] = a.tau[at(t, i, NM, B, b)];
      a.dc[at(t, i, NM, B, b)] = p[i];
    }
    for (int i = 0; i < NM; ++i)
      for (int j = i; j < NM; ++j) {
        const float val = 0.5f * (p[i] * tau[j] + tau[i] * p[j]);
        a.dC[at(t, i * NM + j, NM * NM, B, b)] = val;
        a.dC[at(t, j * NM + i, NM * NM, B, b)] = val;
      }
    for (int i = 0; i < N; ++i) {
      float s2 = 0.0f;
      for (int j = 0; j < NM; ++j) s2 += a.F[at(t, i * NM + j, N * NM, B, b)] * p[j];
      px[i] = s2;
    }
  }

  // ---- 3. multipliers lam, mu (backward), dF, df, dx_init ----
  float lam[N], mu[N];  // lam_{t+1}, mu_{t+1}; zero at t = T-1
  for (int i = 0; i < N; ++i) lam[i] = mu[i] = 0.0f;
  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    float p[NM], tau[NM];
    for (int i = 0; i < NM; ++i) {
      p[i] = a.dc[at(t, i, NM, B, b)];
      tau[i] = a.tau[at(t, i, NM, B, b)];
    }
    for (int i = 0; i < N; ++i) {
      a.df[at(t, i, N, B, b)] = -mu[i];
      for (int j = 0; j < NM; ++j)
        a.dF[at(t, i * NM + j, N * NM, B, b)] = -(mu[i] * tau[j] + lam[i] * p[j]);
    }
    float lam_t[N], mu_t[N];
    for (int i = 0; i < N; ++i) {
      float Ctau = 0.0f, Cp = 0.0f, Flam = 0.0f, Fmu = 0.0f;
      for (int j = 0; j < NM; ++j) {
        const float Cij = a.C[at(t, i * NM + j, NM * NM, B, b)];
        Ctau += Cij * tau[j];
        Cp += Cij * p[j];
      }
      for (int k = 0; k < N; ++k) {
        const float Fki = a.F[at(t, k * NM + i, N * NM, B, b)];
        Flam += Fki * lam[k];
        Fmu += Fki * mu[k];
      }
      lam_t[i] = -(Ctau + a.c[at(t, i, NM, B, b)]) + Flam;
      mu_t[i] = -(Cp + a.r[at(t, i, NM, B, b)]) + Fmu;
    }
    for (int i = 0; i < N; ++i) {
      lam[i] = lam_t[i];
      mu[i] = mu_t[i];
    }
  }
  for (int i = 0; i < N; ++i) a.dx_init[(size_t)i * B + b] = -mu[i];
}
