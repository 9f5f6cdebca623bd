// The alpha-ladder line-search rollout of ONE scenario.
//
// Counterpart of the TPU kernel body _make_kernel in
// diffmpc_tpu/ops/pallas/rollout.py (:45-177), computing what it computes
// with one thread in place of one lane of an (S, 128) tile. csrc/rollout.cu
// runs it on the card with one thread per scenario; the tests build it with
// g++ for the host. diffmpc_tpu_torch/ops/cuda/rollout.py
// (linesearch_rollout_plain) is the same algorithm in plain PyTorch,
// vectorised over the batch.
//
// The accept baseline is the cost of the current trajectory (x_hat, u_hat);
// the rolled ladder alpha = 1, alpha *= decay runs n_alpha closed-loop
// rollouts
//   u_t = clip(clip(u_hat + alpha k + K (x - x_hat), u_hat +- delta_u), box)
// through the dynamics and takes the first strictly improving alpha, else
// alpha_floor = decay^(n_alpha - 1); the chosen rollout is replayed to write
// the trajectory. The dynamics are linear (x' = F_t tau + f_t, LinearEnv) or
// an env's own step (PendulumEnv, NNEnv). The per-step math (rollout_control,
// stage_cost, advance) reads its inputs through an accessor: device memory
// here, a shared-memory slot in the streaming twin rollout_stream.cuh.
//
// Layout: every per-step array is batch-minor, (T, entries..., B).
#pragma once

#include "dual.cuh"

// Launch arguments. The field order is mirrored by ctypes in
// diffmpc_tpu_torch/ops/cuda/rollout.py (_RolloutArgs): keep the two in step.
struct RolloutArgs {
  // inputs
  const float* params;   // env params (P,) shared (params_stride 0) or (B, P)
  const float* C;        // (T, NM, NM, B)
  const float* c;        // (T, NM, B)
  const float* F;        // (T, N, NM, B), linear dynamics only
  const float* f;        // (T, N, B), linear dynamics only; null for zeros
  const float* K;        // (T, M, N, B)
  const float* k;        // (T, M, B)
  const float* x_hat;    // (T, N, B)
  const float* u_hat;    // (T, M, B)
  const float* x_init;   // (N, B)
  const float* u_lower;  // (T, M, B), or null when unconstrained
  const float* u_upper;  // (T, M, B), or null when unconstrained
  // outputs
  float* xs;        // (T, N, B) the accepted trajectory
  float* us;        // (T, M, B)
  float* objs;      // (B,) its cost
  float* alpha;     // (B,) the accepted step
  float* improved;  // (B,) 1.0 where some step improved on (x_hat, u_hat)
  int T;
  int B;
  int params_stride;
  int n_alpha;
  int has_delta_u;
  float decay;
  float alpha_floor;  // decay ** (n_alpha - 1): the pick when no step improves
  float delta_u;
};

// Linear dynamics x_{t+1} = F_t [x; u] + f_t from the args' F, f.
struct LinearEnv {};

namespace rollout_detail {

// element (t, i) of a batch-minor (T, D, B) array, for scenario b
DMPC_HD size_t at(int t, int i, int D, int B, int b) {
  return ((size_t)t * D + i) * (size_t)B + b;
}

}  // namespace rollout_detail

// Step t's inputs for scenario b, read from the args' device memory. An
// accessor gives C(i, j), c(i), K(i, j), k(i), xh(i), uh(i), F(i, j),
// has_f() and f(i) (linear dynamics), has_box(), lo(i) and hi(i).
template <int N, int M>
struct RolloutGlobal {
  static constexpr int NM = N + M;
  const RolloutArgs& a;
  int t;
  int b;
  DMPC_HD size_t at(int i, int D) const { return rollout_detail::at(t, i, D, a.B, b); }
  DMPC_HD float C(int i, int j) const { return a.C[at(i * NM + j, NM * NM)]; }
  DMPC_HD float c(int i) const { return a.c[at(i, NM)]; }
  DMPC_HD float K(int i, int j) const { return a.K[at(i * N + j, M * N)]; }
  DMPC_HD float k(int i) const { return a.k[at(i, M)]; }
  DMPC_HD float xh(int i) const { return a.x_hat[at(i, N)]; }
  DMPC_HD float uh(int i) const { return a.u_hat[at(i, M)]; }
  DMPC_HD float F(int i, int j) const { return a.F[at(i * NM + j, N * NM)]; }
  DMPC_HD bool has_f() const { return a.f != nullptr; }
  DMPC_HD float f(int i) const { return a.f[at(i, N)]; }
  DMPC_HD bool has_box() const { return a.u_lower != nullptr; }
  DMPC_HD float lo(int i) const { return a.u_lower[at(i, M)]; }
  DMPC_HD float hi(int i) const { return a.u_upper[at(i, M)]; }
};

// u = clip(clip(u_hat + alpha k + K (x - x_hat), u_hat +- delta_u), box)
template <int N, int M, class In>
DMPC_HD void rollout_control(const RolloutArgs& a, const In& in, const float (&x)[N], float alpha, float (&u)[M]) {
  for (int i = 0; i < M; ++i) {
    const float uh = in.uh(i);
    float acc = uh + alpha * in.k(i);
    for (int j = 0; j < N; ++j) acc = acc + in.K(i, j) * (x[j] - in.xh(j));
    if (a.has_delta_u) acc = clipf(acc, uh - a.delta_u, uh + a.delta_u);
    if (in.has_box()) acc = clipf(acc, in.lo(i), in.hi(i));
    u[i] = acc;
  }
}

// 0.5 tau'C_t tau + c_t'tau, summed in the TPU kernel's order (stage_cost)
template <int N, int M, class In>
DMPC_HD float stage_cost(const In& in, const float (&x)[N], const float (&u)[M]) {
  constexpr int NM = N + M;
  float tau[NM];
  for (int i = 0; i < N; ++i) tau[i] = x[i];
  for (int i = 0; i < M; ++i) tau[N + i] = u[i];
  float acc = 0.0f;
  for (int i = 0; i < NM; ++i) {
    float Ctau = 0.0f;
    for (int j = 0; j < NM; ++j) Ctau += in.C(i, j) * tau[j];
    acc += (0.5f * Ctau + in.c(i)) * tau[i];
  }
  return acc;
}

// x_{t+1}: the linear step F_t tau + f_t, or the env's own step
template <int N, int M, class In>
DMPC_HD void advance(const In& in, const LinearEnv&, const float*, const float (&x)[N], const float (&u)[M],
                     float (&xn)[N]) {
  constexpr int NM = N + M;
  float tau[NM];
  for (int i = 0; i < N; ++i) tau[i] = x[i];
  for (int i = 0; i < M; ++i) tau[N + i] = u[i];
  for (int i = 0; i < N; ++i) {
    float s = 0.0f;
    for (int j = 0; j < NM; ++j) s += in.F(i, j) * tau[j];
    xn[i] = in.has_f() ? s + in.f(i) : s;
  }
}

template <int N, int M, class In, class Env>
DMPC_HD void advance(const In&, const Env& env, const float* p, const float (&x)[N], const float (&u)[M],
                     float (&xn)[N]) {
  env.step(p, x, u, xn);
}

namespace rollout_detail {

// One closed-loop rollout at step size alpha; returns its cost. With EMIT it
// writes the trajectory: the replay runs the very arithmetic of the ladder's
// rollout at the same alpha, so it reproduces that rollout's cost.
template <int N, int M, class Env, bool EMIT>
DMPC_HD float rollout(const RolloutArgs& a, const Env& env, const float* p, int b, float alpha) {
  const int B = a.B;
  float x[N], u[M], xn[N];
  for (int i = 0; i < N; ++i) x[i] = a.x_init[(size_t)i * B + b];
  float obj = 0.0f;
  for (int t = 0; t < a.T; ++t) {
    const RolloutGlobal<N, M> in{a, t, b};
    rollout_control<N, M>(a, in, x, alpha, u);
    if constexpr (EMIT) {
      for (int i = 0; i < N; ++i) a.xs[at(t, i, N, B, b)] = x[i];
      for (int i = 0; i < M; ++i) a.us[at(t, i, M, B, b)] = u[i];
    }
    obj = obj + stage_cost<N, M>(in, x, u);
    advance<N, M>(in, env, p, x, u, xn);
    for (int i = 0; i < N; ++i) x[i] = xn[i];
  }
  return obj;
}

}  // namespace rollout_detail

// The line search for scenario b, its env's parameters read from `params`
// (a.params, or a block's copy of them in shared memory; null for linear
// dynamics).
template <int N, int M, class Env>
DMPC_HD void linesearch_rollout_scenario(const RolloutArgs& a, const Env& env, int b, const float* params) {
  using namespace rollout_detail;
  const float* p = params ? params + (size_t)b * a.params_stride : nullptr;
  // cost of the current trajectory: the accept baseline
  float obj0 = 0.0f;
  for (int t = 0; t < a.T; ++t) {
    const RolloutGlobal<N, M> in{a, t, b};
    float x[N], u[M];
    for (int i = 0; i < N; ++i) x[i] = in.xh(i);
    for (int i = 0; i < M; ++i) u[i] = in.uh(i);
    obj0 = obj0 + stage_cost<N, M>(in, x, u);
  }
  // the rolled ladder: the first strictly improving step, else alpha_floor
  float alpha = 1.0f, chosen = a.alpha_floor, has = 0.0f;
  for (int ai = 0; ai < a.n_alpha; ++ai) {
    const float obj_a = rollout<N, M, Env, false>(a, env, p, b, alpha);
    if (obj_a < obj0 && has == 0.0f) {
      chosen = alpha;
      has = 1.0f;
    }
    alpha = alpha * a.decay;
  }
  a.objs[b] = rollout<N, M, Env, true>(a, env, p, b, chosen);
  a.alpha[b] = chosen;
  a.improved[b] = has;
}

template <int N, int M, class Env>
DMPC_HD void linesearch_rollout_scenario(const RolloutArgs& a, const Env& env, int b) {
  linesearch_rollout_scenario<N, M>(a, env, b, a.params);
}
