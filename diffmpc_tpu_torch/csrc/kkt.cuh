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
// global scratch, and sweep 3 reads p back from dc (dc = p). The per-step
// math (kkt_aux_step, kkt_diff_step, kkt_next_state, kkt_mult_step, as
// kkt.py:71-161 of the TPU kernel) reads its inputs through an accessor:
// device memory here, a shared-memory slot in the streaming twin
// kkt_stream.cuh.
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

// Step t's inputs for scenario b, read from the args' device memory. An
// accessor gives what its sweep reads: C(i, j), c(i), F(i, j), r(i),
// tau(i), tight(i), the gains K(i, j), k(i) and p(i).
template <int N, int M>
struct KktGlobal {
  static constexpr int NM = N + M;
  const KktArgs& a;
  int t;
  int b;
  DMPC_HD size_t at(int i, int D) const { return kkt_detail::at(t, i, D, a.B, b); }
  DMPC_HD float C(int i, int j) const { return a.C[at(i * NM + j, NM * NM)]; }
  DMPC_HD float c(int i) const { return a.c[at(i, NM)]; }
  DMPC_HD float F(int i, int j) const { return a.F[at(i * NM + j, N * NM)]; }
  DMPC_HD float r(int i) const { return a.r[at(i, NM)]; }
  DMPC_HD float tau(int i) const { return a.tau[at(i, NM)]; }
  DMPC_HD float tight(int i) const { return a.tight[at(i, M)]; }
  DMPC_HD float K(int i, int j) const { return a.K[at(i * N + j, M * N)]; }
  DMPC_HD float k(int i) const { return a.k[at(i, M)]; }
  DMPC_HD float p(int i) const { return a.dc[at(i, NM)]; }  // dc = p
};

// Sweep 1, one backward step of the auxiliary Riccati (tight dims frozen,
// linear term r): the gains K, kt, and the value carry (V, v) in place, by
// the full value update or (EXACT: the gains are exact masked solves) the
// simplified one, the JAX package's VALUE_UPDATE_EXACT_REG gate at kkt.py:105.
// Reads C(i, j) for j >= i, F, r, tight.
template <int N, int M, bool EXACT = false, class In>
DMPC_HD void kkt_aux_step(const In& in, float reg, float (&V)[N][N], float (&v)[N], float (&K)[M][N],
                          float (&kt)[M]) {
  constexpr int NM = N + M;
  float Ft[N][NM];
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < NM; ++j) Ft[i][j] = in.F(i, j);
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
      Q[i][j] = in.C(i, j) + s2;
      Q[j][i] = Q[i][j];
    }
  for (int i = 0; i < NM; ++i) {
    float s2 = 0.0f;
    for (int k = 0; k < N; ++k) s2 += Ft[k][i] * v[k];
    q[i] = in.r(i) + s2;
  }
  // one masked solve for the N columns of Qux and the column qu
  float Quu[M][M], qu[M], frozen[M], rhs[N + 1][M], sol[N + 1][M];
  for (int i = 0; i < M; ++i) {
    for (int j = 0; j < M; ++j) Quu[i][j] = Q[N + i][N + j];
    qu[i] = q[N + i];
    frozen[i] = in.tight(i);
    for (int j = 0; j < N; ++j) rhs[j][i] = Q[N + i][j];
    rhs[N][i] = qu[i];
  }
  masked_chol_solve<M, N + 1>(Quu, rhs, frozen, reg, sol);
  for (int i = 0; i < M; ++i) {
    for (int j = 0; j < N; ++j) K[i][j] = -sol[j][i];
    kt[i] = -sol[N][i];
  }
  value_update<N, M, EXACT>(Q, q, Quu, qu, K, kt, V, v);
}

// Sweep 2, the differential step p = [px; k + K px]. Reads K, k.
template <int N, int M, class In>
DMPC_HD void kkt_diff_step(const In& in, const float (&px)[N], float (&p)[N + M]) {
  for (int i = 0; i < N; ++i) p[i] = px[i];
  for (int i = 0; i < M; ++i) {
    float s2 = 0.0f;
    for (int j = 0; j < N; ++j) s2 += in.K(i, j) * px[j];
    p[N + i] = in.k(i) + s2;
  }
}

// Sweep 2, the next differential state px = F p (f = 0). Reads F.
template <int N, int M, class In>
DMPC_HD void kkt_next_state(const In& in, const float (&p)[N + M], float (&px)[N]) {
  for (int i = 0; i < N; ++i) {
    float s2 = 0.0f;
    for (int j = 0; j < N + M; ++j) s2 += in.F(i, j) * p[j];
    px[i] = s2;
  }
}

// Sweep 3, one backward step of both multiplier recursions
// lam_t = -(C tau + c)_x + Fx' lam_{t+1}, mu_t = -(C p + r)_x + Fx' mu_{t+1},
// in place. Reads C(i, j) and c(i), r(i) for i < N, and F.
template <int N, int M, class In>
DMPC_HD void kkt_mult_step(const In& in, const float (&tau)[N + M], const float (&p)[N + M], float (&lam)[N],
                           float (&mu)[N]) {
  constexpr int NM = N + M;
  float lam_t[N], mu_t[N];
  for (int i = 0; i < N; ++i) {
    float Ctau = 0.0f, Cp = 0.0f, Flam = 0.0f, Fmu = 0.0f;
    for (int j = 0; j < NM; ++j) {
      const float Cij = in.C(i, j);
      Ctau += Cij * tau[j];
      Cp += Cij * p[j];
    }
    for (int k = 0; k < N; ++k) {
      const float Fki = in.F(k, i);
      Flam += Fki * lam[k];
      Fmu += Fki * mu[k];
    }
    lam_t[i] = -(Ctau + in.c(i)) + Flam;
    mu_t[i] = -(Cp + in.r(i)) + Fmu;
  }
  for (int i = 0; i < N; ++i) {
    lam[i] = lam_t[i];
    mu[i] = mu_t[i];
  }
}

// Sweep 1's output: the gains into the scratch K, k.
template <int N, int M>
DMPC_HD void kkt_store_gains(const KktArgs& a, int t, int b, const float (&K)[M][N], const float (&kt)[M]) {
  using kkt_detail::at;
  for (int i = 0; i < M; ++i) {
    for (int j = 0; j < N; ++j) a.K[at(t, i * N + j, M * N, a.B, b)] = K[i][j];
    a.k[at(t, i, M, a.B, b)] = kt[i];
  }
}

// Sweep 2's outputs: dc = p and dC = 1/2 (p tau' + tau p').
template <int N, int M>
DMPC_HD void kkt_store_cost_grad(const KktArgs& a, int t, int b, const float (&p)[N + M], const float (&tau)[N + M]) {
  using kkt_detail::at;
  constexpr int NM = N + M;
  for (int i = 0; i < NM; ++i) a.dc[at(t, i, NM, a.B, b)] = p[i];
  for (int i = 0; i < NM; ++i)
    for (int j = i; j < NM; ++j) {
      const float val = 0.5f * (p[i] * tau[j] + tau[i] * p[j]);
      a.dC[at(t, i * NM + j, NM * NM, a.B, b)] = val;
      a.dC[at(t, j * NM + i, NM * NM, a.B, b)] = val;
    }
}

// Sweep 3's outputs: dF = -(mu_{t+1} tau' + lam_{t+1} p'), df = -mu_{t+1}.
template <int N, int M>
DMPC_HD void kkt_store_dyn_grad(const KktArgs& a, int t, int b, const float (&lam)[N], const float (&mu)[N],
                                const float (&tau)[N + M], const float (&p)[N + M]) {
  using kkt_detail::at;
  constexpr int NM = N + M;
  for (int i = 0; i < N; ++i) {
    a.df[at(t, i, N, a.B, b)] = -mu[i];
    for (int j = 0; j < NM; ++j) a.dF[at(t, i * NM + j, N * NM, a.B, b)] = -(mu[i] * tau[j] + lam[i] * p[j]);
  }
}

template <int N, int M, bool EXACT = false>
DMPC_HD void kkt_backward_scenario(const KktArgs& a, int b) {
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
    float K[M][N], kt[M];
    kkt_aux_step<N, M, EXACT>(KktGlobal<N, M>{a, t, b}, a.reg, V, v, K, kt);
    kkt_store_gains<N, M>(a, t, b, K, kt);
  }

  // ---- 2. differential rollout p (f = 0, p_x0 = 0), dC and dc ----
  float px[N];
  for (int i = 0; i < N; ++i) px[i] = 0.0f;
  for (int t = 0; t < T; ++t) {
    const KktGlobal<N, M> in{a, t, b};
    float p[NM], tau[NM];
    kkt_diff_step<N, M>(in, px, p);
    for (int i = 0; i < NM; ++i) tau[i] = in.tau(i);
    kkt_store_cost_grad<N, M>(a, t, b, p, tau);
    kkt_next_state<N, M>(in, p, px);
  }

  // ---- 3. multipliers lam, mu (backward), dF, df, dx_init ----
  float lam[N], mu[N];  // lam_{t+1}, mu_{t+1}; zero at t = T-1
  for (int i = 0; i < N; ++i) lam[i] = mu[i] = 0.0f;
  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    const KktGlobal<N, M> in{a, t, b};
    float p[NM], tau[NM];
    for (int i = 0; i < NM; ++i) {
      p[i] = in.p(i);
      tau[i] = in.tau(i);
    }
    kkt_store_dyn_grad<N, M>(a, t, b, lam, mu, tau, p);
    kkt_mult_step<N, M>(in, tau, p, lam, mu);
  }
  for (int i = 0; i < N; ++i) a.dx_init[(size_t)i * B + b] = -mu[i];
}
