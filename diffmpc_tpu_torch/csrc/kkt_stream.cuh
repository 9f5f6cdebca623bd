// The analytic KKT backward of ONE scenario, streamed step by step.
//
// Counterpart of the TPU kernel body _make_kernel in
// diffmpc_tpu/ops/pallas/kkt_stream.py (:49-200): the three sweeps of
// kkt.cuh, each streaming its own per-step slices through two shared-memory
// slots (stream.cuh) while the step before computes:
//   1. the auxiliary Riccati, backward: C's upper triangle, F, r, tight;
//      writes the gains K, k to device scratch;
//   2. the differential rollout, forward: K, k, F, tau; writes dc = p, dC;
//   3. the multipliers, backward: C's first N rows, c, F, r, tau and p (read
//      back from dc); writes dF, df and dx_init.
// K, k and p are staged in device memory between the sweeps, as on the TPU.
// The per-step math is kkt.cuh's (kkt_aux_step, kkt_diff_step,
// kkt_next_state, kkt_mult_step), read through slot accessors in place of
// KktGlobal, so the twin computes what the resident kernel computes.
//
// csrc/kkt_stream.cu runs it on the card; the tests build it with g++. Its
// plain version is the resident kernel's, kkt_backward_plain
// (diffmpc_tpu_torch/ops/cuda/kkt.py).
#pragma once

#include "kkt.cuh"
#include "stream.cuh"

// The three sweeps' slices and their accessors.
template <int N, int M>
struct KktAuxSlot {  // sweep 1: C's upper triangle, F, r, tight
  static constexpr int NM = N + M;
  static constexpr int kF = NM * (NM + 1) / 2;
  static constexpr int kr = kF + N * NM;
  static constexpr int kTight = kr + NM;
  static constexpr int kSize = kTight + M;
  SlotReader e;
  DMPC_HD float C(int i, int j) const { return e[upper_index(NM, i, j)]; }
  DMPC_HD float F(int i, int j) const { return e[kF + i * NM + j]; }
  DMPC_HD float r(int i) const { return e[kr + i]; }
  DMPC_HD float tight(int i) const { return e[kTight + i]; }
};

template <int N, int M>
struct KktDiffSlot {  // sweep 2: K, k, F, tau
  static constexpr int NM = N + M;
  static constexpr int kk = M * N;
  static constexpr int kF = kk + M;
  static constexpr int kTau = kF + N * NM;
  static constexpr int kSize = kTau + NM;
  SlotReader e;
  DMPC_HD float K(int i, int j) const { return e[i * N + j]; }
  DMPC_HD float k(int i) const { return e[kk + i]; }
  DMPC_HD float F(int i, int j) const { return e[kF + i * NM + j]; }
  DMPC_HD float tau(int i) const { return e[kTau + i]; }
};

template <int N, int M>
struct KktMultSlot {  // sweep 3: C's first N rows, c and r's first N entries, F, tau, p
  static constexpr int NM = N + M;
  static constexpr int kc = N * NM;
  static constexpr int kF = kc + N;
  static constexpr int kr = kF + N * NM;
  static constexpr int kTau = kr + N;
  static constexpr int kp = kTau + NM;
  static constexpr int kSize = kp + NM;
  SlotReader e;
  DMPC_HD float C(int i, int j) const { return e[i * NM + j]; }
  DMPC_HD float c(int i) const { return e[kc + i]; }
  DMPC_HD float F(int i, int j) const { return e[kF + i * NM + j]; }
  DMPC_HD float r(int i) const { return e[kr + i]; }
  DMPC_HD float tau(int i) const { return e[kTau + i]; }
  DMPC_HD float p(int i) const { return e[kp + i]; }
};

// Entries per slot: the largest of the three slices.
template <int N, int M>
struct KktSlotSize {
  static constexpr int s1 = KktAuxSlot<N, M>::kSize, s2 = KktDiffSlot<N, M>::kSize, s3 = KktMultSlot<N, M>::kSize;
  static constexpr int value = s1 > s2 ? (s1 > s3 ? s1 : s3) : (s2 > s3 ? s2 : s3);
};

// Start the copies of step t's slice of sweep SWEEP (1, 2 or 3) into `slot`.
template <int N, int M, int SWEEP>
DMPC_HD void kkt_stream_load(const KktArgs& a, int t, int b, float* slot, int stride) {
  using kkt_detail::at;
  constexpr int NM = N + M;
  const int B = a.B;
  if constexpr (SWEEP == 1) {
    using S = KktAuxSlot<N, M>;
    for (int i = 0; i < NM; ++i)
      for (int j = i; j < NM; ++j)
        stream_put(slot, stride, upper_index(NM, i, j), &a.C[at(t, i * NM + j, NM * NM, B, b)]);
    for (int i = 0; i < N * NM; ++i) stream_put(slot, stride, S::kF + i, &a.F[at(t, i, N * NM, B, b)]);
    for (int i = 0; i < NM; ++i) stream_put(slot, stride, S::kr + i, &a.r[at(t, i, NM, B, b)]);
    for (int i = 0; i < M; ++i) stream_put(slot, stride, S::kTight + i, &a.tight[at(t, i, M, B, b)]);
  } else if constexpr (SWEEP == 2) {
    using S = KktDiffSlot<N, M>;
    for (int i = 0; i < M * N; ++i) stream_put(slot, stride, i, &a.K[at(t, i, M * N, B, b)]);
    for (int i = 0; i < M; ++i) stream_put(slot, stride, S::kk + i, &a.k[at(t, i, M, B, b)]);
    for (int i = 0; i < N * NM; ++i) stream_put(slot, stride, S::kF + i, &a.F[at(t, i, N * NM, B, b)]);
    for (int i = 0; i < NM; ++i) stream_put(slot, stride, S::kTau + i, &a.tau[at(t, i, NM, B, b)]);
  } else {
    using S = KktMultSlot<N, M>;
    for (int i = 0; i < N * NM; ++i) stream_put(slot, stride, i, &a.C[at(t, i, NM * NM, B, b)]);
    for (int i = 0; i < N; ++i) stream_put(slot, stride, S::kc + i, &a.c[at(t, i, NM, B, b)]);
    for (int i = 0; i < N * NM; ++i) stream_put(slot, stride, S::kF + i, &a.F[at(t, i, N * NM, B, b)]);
    for (int i = 0; i < N; ++i) stream_put(slot, stride, S::kr + i, &a.r[at(t, i, NM, B, b)]);
    for (int i = 0; i < NM; ++i) stream_put(slot, stride, S::kTau + i, &a.tau[at(t, i, NM, B, b)]);
    for (int i = 0; i < NM; ++i) stream_put(slot, stride, S::kp + i, &a.dc[at(t, i, NM, B, b)]);  // dc = p
  }
  stream_commit();
}

// The slot of the s-th step of a sweep visiting steps t(0), t(1), ...: issue
// the copies of the next step, t_next (none when s is the last), and wait for
// this step's slice.
template <int N, int M, int SWEEP>
DMPC_HD SlotReader kkt_stream_step(const KktArgs& a, int s, int t_next, int b, float* buf, int stride) {
  constexpr int kSize = KktSlotSize<N, M>::value;
  if (s + 1 < a.T) {
    kkt_stream_load<N, M, SWEEP>(a, t_next, b, buf + (size_t)((s + 1) & 1) * kSize * stride, stride);
    stream_wait<1>();
  } else {
    stream_wait<0>();
  }
  return SlotReader{buf + (size_t)(s & 1) * kSize * stride, stride};
}

// The backward for scenario b; `buf` holds this thread's two slots of
// KktSlotSize<N, M>::value entries each, entries `stride` apart. EXACT is
// kkt_aux_step's.
template <int N, int M, bool EXACT = false>
DMPC_HD void kkt_stream_scenario(const KktArgs& a, int b, float* buf, int stride) {
  constexpr int NM = N + M;
  const int T = a.T, B = a.B;

  // ---- 1. auxiliary Riccati, backward; K, k to the scratch ----
  float V[N][N], v[N];
  for (int i = 0; i < N; ++i) {
    v[i] = 0.0f;
    for (int j = 0; j < N; ++j) V[i][j] = 0.0f;
  }
  if (T > 0) kkt_stream_load<N, M, 1>(a, T - 1, b, buf, stride);
  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    const KktAuxSlot<N, M> in{kkt_stream_step<N, M, 1>(a, s, t - 1, b, buf, stride)};
    float K[M][N], kt[M];
    kkt_aux_step<N, M, EXACT>(in, a.reg, V, v, K, kt);
    kkt_store_gains<N, M>(a, t, b, K, kt);
  }
  stream_fence();  // sweep 2 streams the gains this thread just wrote

  // ---- 2. differential rollout, forward; dc = p and dC ----
  float px[N];
  for (int i = 0; i < N; ++i) px[i] = 0.0f;
  if (T > 0) kkt_stream_load<N, M, 2>(a, 0, b, buf, stride);
  for (int t = 0; t < T; ++t) {
    const KktDiffSlot<N, M> in{kkt_stream_step<N, M, 2>(a, t, t + 1, b, buf, stride)};
    float p[NM], tau[NM];
    kkt_diff_step<N, M>(in, px, p);
    for (int i = 0; i < NM; ++i) tau[i] = in.tau(i);
    kkt_store_cost_grad<N, M>(a, t, b, p, tau);
    kkt_next_state<N, M>(in, p, px);
  }
  stream_fence();  // sweep 3 streams p back from dc

  // ---- 3. multipliers, backward; dF, df, dx_init ----
  float lam[N], mu[N];  // lam_{t+1}, mu_{t+1}; zero at t = T-1
  for (int i = 0; i < N; ++i) lam[i] = mu[i] = 0.0f;
  if (T > 0) kkt_stream_load<N, M, 3>(a, T - 1, b, buf, stride);
  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    const KktMultSlot<N, M> in{kkt_stream_step<N, M, 3>(a, s, t - 1, b, buf, stride)};
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
