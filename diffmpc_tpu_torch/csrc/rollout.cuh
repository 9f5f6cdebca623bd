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
// an env's own step (PendulumEnv).
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

template <int N, int M>
DMPC_HD void advance(const RolloutArgs& a, const LinearEnv&, const float*, int t, int b,
                     const float (&x)[N], const float (&u)[M], float (&xn)[N]) {
  constexpr int NM = N + M;
  float tau[NM];
  for (int i = 0; i < N; ++i) tau[i] = x[i];
  for (int i = 0; i < M; ++i) tau[N + i] = u[i];
  for (int i = 0; i < N; ++i) {
    float s = 0.0f;
    for (int j = 0; j < NM; ++j) s += a.F[at(t, i * NM + j, N * NM, a.B, b)] * tau[j];
    xn[i] = a.f ? s + a.f[at(t, i, N, a.B, b)] : s;
  }
}

template <int N, int M, class Env>
DMPC_HD void advance(const RolloutArgs&, const Env& env, const float* p, int, int,
                     const float (&x)[N], const float (&u)[M], float (&xn)[N]) {
  env.step(p, x, u, xn);
}

// 0.5 tau'C_t tau + c_t'tau, summed in the TPU kernel's order (stage_cost)
template <int N, int M>
DMPC_HD float stage_cost(const RolloutArgs& a, int t, int b, const float (&x)[N], const float (&u)[M]) {
  constexpr int NM = N + M;
  float tau[NM];
  for (int i = 0; i < N; ++i) tau[i] = x[i];
  for (int i = 0; i < M; ++i) tau[N + i] = u[i];
  float acc = 0.0f;
  for (int i = 0; i < NM; ++i) {
    float Ctau = 0.0f;
    for (int j = 0; j < NM; ++j) Ctau += a.C[at(t, i * NM + j, NM * NM, a.B, b)] * tau[j];
    acc += (0.5f * Ctau + a.c[at(t, i, NM, a.B, b)]) * tau[i];
  }
  return acc;
}

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
    for (int i = 0; i < M; ++i) {
      const float uh = a.u_hat[at(t, i, M, B, b)];
      float acc = uh + alpha * a.k[at(t, i, M, B, b)];
      for (int j = 0; j < N; ++j)
        acc = acc + a.K[at(t, i * N + j, M * N, B, b)] * (x[j] - a.x_hat[at(t, j, N, B, b)]);
      if (a.has_delta_u) acc = clipf(acc, uh - a.delta_u, uh + a.delta_u);
      if (a.u_lower) acc = clipf(acc, a.u_lower[at(t, i, M, B, b)], a.u_upper[at(t, i, M, B, b)]);
      u[i] = acc;
    }
    if constexpr (EMIT) {
      for (int i = 0; i < N; ++i) a.xs[at(t, i, N, B, b)] = x[i];
      for (int i = 0; i < M; ++i) a.us[at(t, i, M, B, b)] = u[i];
    }
    obj = obj + stage_cost<N, M>(a, t, b, x, u);
    advance<N, M>(a, env, p, t, b, x, u, xn);
    for (int i = 0; i < N; ++i) x[i] = xn[i];
  }
  return obj;
}

}  // namespace rollout_detail

template <int N, int M, class Env>
DMPC_HD void linesearch_rollout_scenario(const RolloutArgs& a, const Env& env, int b) {
  using namespace rollout_detail;
  const int B = a.B;
  const float* p = a.params ? a.params + (size_t)b * a.params_stride : nullptr;
  // cost of the current trajectory: the accept baseline
  float obj0 = 0.0f;
  for (int t = 0; t < a.T; ++t) {
    float x[N], u[M];
    for (int i = 0; i < N; ++i) x[i] = a.x_hat[at(t, i, N, B, b)];
    for (int i = 0; i < M; ++i) u[i] = a.u_hat[at(t, i, M, B, b)];
    obj0 = obj0 + stage_cost<N, M>(a, t, b, x, u);
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
