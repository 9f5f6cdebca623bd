// The Riccati backward sweep of ONE scenario, streamed step by step.
//
// Counterpart of the TPU kernel body _make_kernel in
// diffmpc_tpu/ops/pallas/riccati_stream.py (:43-168): the sweep of
// riccati.cuh (free, box with the m = 2 enumeration, mask), with each step's
// input slice double-buffered through shared memory (stream.cuh) instead of
// read from device memory where the step needs it. Step t computes from one
// slot while step t-1's slice lands in the other. The per-step math is
// riccati.cuh's riccati_step, read through RiccatiSlot in place of
// RiccatiGlobal, so the twin computes what the resident kernel computes.
// The gains go straight from registers to device memory: the TPU stages its
// outputs only because its writes are DMAs.
//
// csrc/riccati_stream.cu runs it on the card; the tests build it with g++.
// Its plain version is the resident kernel's, riccati_backward_plain
// (diffmpc_tpu_torch/ops/cuda/riccati.py).
#pragma once

#include "riccati.cuh"
#include "stream.cuh"

// One step's slice: C's upper triangle (row by row), c, F, f, then lo, hi
// (box mode) or the mask (mask mode). f is copied only when the args have it.
template <int N, int M, int MODE>
struct RiccatiSlice {
  static constexpr int NM = N + M;
  static constexpr int kc = NM * (NM + 1) / 2;
  static constexpr int kF = kc + NM;
  static constexpr int kf = kF + N * NM;
  static constexpr int kExtra = kf + N;
  static constexpr int kSize = kExtra + (MODE == kRiccatiBox ? 2 * M : MODE == kRiccatiMask ? M : 0);
};

// Step inputs from a slot: the accessor of riccati_step.
template <int N, int M, int MODE>
struct RiccatiSlot {
  using S = RiccatiSlice<N, M, MODE>;
  SlotReader e;
  bool f_;
  DMPC_HD float C(int i, int j) const { return e[upper_index(S::NM, i, j)]; }
  DMPC_HD float c(int i) const { return e[S::kc + i]; }
  DMPC_HD float F(int i, int j) const { return e[S::kF + i * S::NM + j]; }
  DMPC_HD bool has_f() const { return f_; }
  DMPC_HD float f(int i) const { return e[S::kf + i]; }
  DMPC_HD float lo(int i) const { return e[S::kExtra + i]; }
  DMPC_HD float hi(int i) const { return e[S::kExtra + M + i]; }
  DMPC_HD float mask(int i) const { return e[S::kExtra + i]; }
};

// Start the copies of step t's slice into `slot` (entry e at slot[e * stride]).
template <int N, int M, int MODE>
DMPC_HD void riccati_stream_load(const RiccatiArgs& a, int t, int b, float* slot, int stride) {
  using riccati_detail::at;
  using S = RiccatiSlice<N, M, MODE>;
  constexpr int NM = N + M;
  const int B = a.B;
  for (int i = 0; i < NM; ++i)
    for (int j = i; j < NM; ++j)
      stream_put(slot, stride, upper_index(NM, i, j), &a.C[at(t, i * NM + j, NM * NM, B, b)]);
  for (int i = 0; i < NM; ++i) stream_put(slot, stride, S::kc + i, &a.c[at(t, i, NM, B, b)]);
  for (int i = 0; i < N * NM; ++i) stream_put(slot, stride, S::kF + i, &a.F[at(t, i, N * NM, B, b)]);
  if (a.f)
    for (int i = 0; i < N; ++i) stream_put(slot, stride, S::kf + i, &a.f[at(t, i, N, B, b)]);
  for (int i = 0; i < M; ++i) {
    if constexpr (MODE == kRiccatiBox) {
      stream_put(slot, stride, S::kExtra + i, &a.lo[at(t, i, M, B, b)]);
      stream_put(slot, stride, S::kExtra + M + i, &a.hi[at(t, i, M, B, b)]);
    } else if constexpr (MODE == kRiccatiMask) {
      stream_put(slot, stride, S::kExtra + i, &a.mask[at(t, i, M, B, b)]);
    }
  }
  stream_commit();
}

// The sweep t = T-1..0 for scenario b; `buf` holds this thread's two slots
// of RiccatiSlice<N, M, MODE>::kSize entries each, entries `stride` apart.
template <int N, int M, int MODE>
DMPC_HD void riccati_stream_scenario(const RiccatiArgs& a, int b, float* buf, int stride) {
  using S = RiccatiSlice<N, M, MODE>;
  const int T = a.T;
  float V[N][N], v[N];
  for (int i = 0; i < N; ++i) {
    v[i] = 0.0f;
    for (int j = 0; j < N; ++j) V[i][j] = 0.0f;
  }
  if (T > 0) riccati_stream_load<N, M, MODE>(a, T - 1, b, buf, stride);
  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    float* slot = buf + (size_t)(s & 1) * S::kSize * stride;
    if (s + 1 < T) {  // the next step's slice lands while this one computes
      riccati_stream_load<N, M, MODE>(a, t - 1, b, buf + (size_t)((s + 1) & 1) * S::kSize * stride, stride);
      stream_wait<1>();
    } else {
      stream_wait<0>();
    }
    float K[M][N], kt[M], frozen[M];
    const RiccatiSlot<N, M, MODE> in{SlotReader{slot, stride}, a.f != nullptr};
    const float n_qp = riccati_step<N, M, MODE>(in, a.pnqp_iter, a.reg, V, v, K, kt, frozen);
    riccati_store<N, M, MODE>(a, t, b, K, kt, frozen, n_qp);
  }
}
