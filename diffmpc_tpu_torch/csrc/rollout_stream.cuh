// The alpha-ladder line search of ONE scenario, streamed in two passes.
//
// Counterpart of the TPU kernel body _make_kernel in
// diffmpc_tpu/ops/pallas/rollout_stream.py (:35-193), whose algorithm it
// keeps, and not the resident kernel's (rollout.cuh):
//   pass 1 streams each step's slice once and advances every ladder state
//          (alpha = 1, alpha *= decay, n_alpha of them) and the (x_hat, u_hat)
//          baseline through it, each with its own running cost;
//   then   the first strictly improving alpha, else alpha_floor;
//   pass 2 streams the horizon again and replays the chosen step, writing
//          xs, us, its cost, alpha and improved.
// So the horizon is read twice, where the resident kernel reads it
// n_alpha + 2 times. Each step's slice is double-buffered through shared
// memory (stream.cuh). The per-step math is rollout.cuh's rollout_control,
// stage_cost and advance, read through RolloutSlot: each ladder cost is the
// resident ladder's arithmetic at the same alpha, and the replay reproduces
// the chosen rollout's cost.
//
// The ladder states live in registers, kLadder of them per pass: a longer
// ladder takes pass 1 in chunks of kLadder, one more read of the horizon each.
//
// csrc/rollout_stream.cu runs it on the card; the tests build it with g++.
// Its plain version is the resident kernel's, linesearch_rollout_plain
// (diffmpc_tpu_torch/ops/cuda/rollout.py).
#pragma once

#include "rollout.cuh"
#include "stream.cuh"

constexpr int kLadder = 10;  // ladder states per pass 1: the default max_linesearch_iter

template <class Env>
struct IsLinearEnv {
  static constexpr bool value = false;
};
template <>
struct IsLinearEnv<LinearEnv> {
  static constexpr bool value = true;
};

// One step's slice: C (all of it: the stage cost reads both triangles), c, K,
// k, x_hat, u_hat, the box, then F and f for linear dynamics. The box and f
// are copied only when the args have them.
template <int N, int M, class Env>
struct RolloutSlice {
  static constexpr int NM = N + M;
  static constexpr int kc = NM * NM;
  static constexpr int kK = kc + NM;
  static constexpr int kk = kK + M * N;
  static constexpr int kxh = kk + M;
  static constexpr int kuh = kxh + N;
  static constexpr int klo = kuh + M;
  static constexpr int khi = klo + M;
  static constexpr int kF = khi + M;
  static constexpr int kf = kF + N * NM;
  static constexpr int kSize = IsLinearEnv<Env>::value ? kf + N : kF;
};

// Step inputs from a slot: the accessor of rollout_control, stage_cost and
// advance.
template <int N, int M, class Env>
struct RolloutSlot {
  using S = RolloutSlice<N, M, Env>;
  SlotReader e;
  bool f_;
  bool box_;
  DMPC_HD float C(int i, int j) const { return e[i * S::NM + j]; }
  DMPC_HD float c(int i) const { return e[S::kc + i]; }
  DMPC_HD float K(int i, int j) const { return e[S::kK + i * N + j]; }
  DMPC_HD float k(int i) const { return e[S::kk + i]; }
  DMPC_HD float xh(int i) const { return e[S::kxh + i]; }
  DMPC_HD float uh(int i) const { return e[S::kuh + i]; }
  DMPC_HD bool has_box() const { return box_; }
  DMPC_HD float lo(int i) const { return e[S::klo + i]; }
  DMPC_HD float hi(int i) const { return e[S::khi + i]; }
  DMPC_HD float F(int i, int j) const { return e[S::kF + i * S::NM + j]; }
  DMPC_HD bool has_f() const { return f_; }
  DMPC_HD float f(int i) const { return e[S::kf + i]; }
};

// Start the copies of step t's slice into `slot` (entry e at slot[e * stride]).
template <int N, int M, class Env>
DMPC_HD void rollout_stream_load(const RolloutArgs& a, int t, int b, float* slot, int stride) {
  using rollout_detail::at;
  using S = RolloutSlice<N, M, Env>;
  constexpr int NM = N + M;
  const int B = a.B;
  for (int i = 0; i < NM * NM; ++i) stream_put(slot, stride, i, &a.C[at(t, i, NM * NM, B, b)]);
  for (int i = 0; i < NM; ++i) stream_put(slot, stride, S::kc + i, &a.c[at(t, i, NM, B, b)]);
  for (int i = 0; i < M * N; ++i) stream_put(slot, stride, S::kK + i, &a.K[at(t, i, M * N, B, b)]);
  for (int i = 0; i < M; ++i) stream_put(slot, stride, S::kk + i, &a.k[at(t, i, M, B, b)]);
  for (int i = 0; i < N; ++i) stream_put(slot, stride, S::kxh + i, &a.x_hat[at(t, i, N, B, b)]);
  for (int i = 0; i < M; ++i) stream_put(slot, stride, S::kuh + i, &a.u_hat[at(t, i, M, B, b)]);
  if (a.u_lower)
    for (int i = 0; i < M; ++i) {
      stream_put(slot, stride, S::klo + i, &a.u_lower[at(t, i, M, B, b)]);
      stream_put(slot, stride, S::khi + i, &a.u_upper[at(t, i, M, B, b)]);
    }
  if constexpr (IsLinearEnv<Env>::value) {
    for (int i = 0; i < N * NM; ++i) stream_put(slot, stride, S::kF + i, &a.F[at(t, i, N * NM, B, b)]);
    if (a.f)
      for (int i = 0; i < N; ++i) stream_put(slot, stride, S::kf + i, &a.f[at(t, i, N, B, b)]);
  }
  stream_commit();
}

// Issue step t+1's copies (if any) and wait for step t's slice; returns it.
template <int N, int M, class Env>
DMPC_HD RolloutSlot<N, M, Env> rollout_stream_step(const RolloutArgs& a, int t, int b, float* buf, int stride) {
  constexpr int kSize = RolloutSlice<N, M, Env>::kSize;
  if (t + 1 < a.T) {
    rollout_stream_load<N, M, Env>(a, t + 1, b, buf + (size_t)((t + 1) & 1) * kSize * stride, stride);
    stream_wait<1>();
  } else {
    stream_wait<0>();
  }
  return RolloutSlot<N, M, Env>{SlotReader{buf + (size_t)(t & 1) * kSize * stride, stride}, a.f != nullptr,
                                a.u_lower != nullptr};
}

// The line search for scenario b; `buf` holds this thread's two slots of
// RolloutSlice<N, M, Env>::kSize entries each, entries `stride` apart. The
// env's parameters are read from `params` (a.params, or a block's copy of
// them in shared memory; null for linear dynamics).
template <int N, int M, class Env>
DMPC_HD void linesearch_rollout_stream_scenario(const RolloutArgs& a, const Env& env, int b, float* buf,
                                                int stride, const float* params) {
  const int T = a.T, B = a.B;
  const float* p = params ? params + (size_t)b * a.params_stride : nullptr;
  float x0[N];
  for (int i = 0; i < N; ++i) x0[i] = a.x_init[(size_t)i * B + b];

  // ---- pass 1: the ladder's rollouts side by side, and the baseline ----
  float alpha = 1.0f, chosen = a.alpha_floor, has = 0.0f, obj0 = 0.0f;
  for (int a0 = 0; a0 < a.n_alpha; a0 += kLadder) {
    const int na = a.n_alpha - a0 < kLadder ? a.n_alpha - a0 : kLadder;
    float al[kLadder], obj[kLadder], x[kLadder][N];
#pragma unroll
    for (int j = 0; j < kLadder; ++j) {
      al[j] = alpha;
      if (j < na) alpha = alpha * a.decay;
      obj[j] = 0.0f;
      for (int i = 0; i < N; ++i) x[j][i] = x0[i];
    }
    if (T > 0) rollout_stream_load<N, M, Env>(a, 0, b, buf, stride);
    for (int t = 0; t < T; ++t) {
      const RolloutSlot<N, M, Env> in = rollout_stream_step<N, M, Env>(a, t, b, buf, stride);
#pragma unroll
      for (int j = 0; j < kLadder; ++j) {
        if (j < na) {
          float u[M], xn[N];
          rollout_control<N, M>(a, in, x[j], al[j], u);
          obj[j] = obj[j] + stage_cost<N, M>(in, x[j], u);
          advance<N, M>(in, env, p, x[j], u, xn);
          for (int i = 0; i < N; ++i) x[j][i] = xn[i];
        }
      }
      if (a0 == 0) {
        float xh[N], uh[M];
        for (int i = 0; i < N; ++i) xh[i] = in.xh(i);
        for (int i = 0; i < M; ++i) uh[i] = in.uh(i);
        obj0 = obj0 + stage_cost<N, M>(in, xh, uh);
      }
    }
#pragma unroll
    for (int j = 0; j < kLadder; ++j) {
      if (j < na && obj[j] < obj0 && has == 0.0f) {
        chosen = al[j];
        has = 1.0f;
      }
    }
  }

  // ---- pass 2: replay the chosen step, writing the trajectory ----
  float x[N], obj = 0.0f;
  for (int i = 0; i < N; ++i) x[i] = x0[i];
  if (T > 0) rollout_stream_load<N, M, Env>(a, 0, b, buf, stride);
  for (int t = 0; t < T; ++t) {
    const RolloutSlot<N, M, Env> in = rollout_stream_step<N, M, Env>(a, t, b, buf, stride);
    float u[M], xn[N];
    rollout_control<N, M>(a, in, x, chosen, u);
    for (int i = 0; i < N; ++i) a.xs[rollout_detail::at(t, i, N, B, b)] = x[i];
    for (int i = 0; i < M; ++i) a.us[rollout_detail::at(t, i, M, B, b)] = u[i];
    obj = obj + stage_cost<N, M>(in, x, u);
    advance<N, M>(in, env, p, x, u, xn);
    for (int i = 0; i < N; ++i) x[i] = xn[i];
  }
  a.objs[b] = obj;
  a.alpha[b] = chosen;
  a.improved[b] = has;
}

template <int N, int M, class Env>
DMPC_HD void linesearch_rollout_stream_scenario(const RolloutArgs& a, const Env& env, int b, float* buf,
                                                int stride) {
  linesearch_rollout_stream_scenario<N, M>(a, env, b, buf, stride, a.params);
}
