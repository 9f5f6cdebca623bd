// The whole box-constrained iLQR solve of ONE scenario.
//
// Counterpart of the TPU kernel body _make_kernel in
// diffmpc_tpu/ops/pallas/ilqr.py (:89-455), computing what it computes,
// with one thread in place of one lane of an (S, 128) tile. csrc/ilqr.cu
// runs it on the card with one thread per scenario; the tests build it with
// g++ for the host. diffmpc_tpu_torch/ops/cuda/ilqr.py (ilqr_solve_plain)
// is the same algorithm in plain PyTorch, vectorised over the batch.
//
// Layout: every per-step array is batch-minor, (T, entries..., B), so that
// neighbouring threads touch neighbouring addresses. The value carry
// (V, v) and the per-step Q, q, W live in registers.
//
// HoistLin (the TPU kernel's hoist_lin=True, pre_body at ilqr.py:234-249):
// before each sweep a loop over t linearizes every step and forms its delta
// cost into the scratch F_s, cd_s; the sweep then reads them, so the
// Jacobian leaves the value carry's chain of dependences. The same
// operations on the same values: with the flag off the program is the one
// without the pre-pass.
#pragma once

#include "dual.cuh"
#include "riccati_entries.cuh"

// Launch arguments. The field order is mirrored by ctypes in
// diffmpc_tpu_torch/ops/cuda/ilqr.py (_IlqrArgs): keep the two in step.
struct IlqrArgs {
  // inputs
  const float* params;   // (P,) shared (params_stride 0) or (B, P) (stride P)
  const float* C;        // (T, NM, NM, B)
  const float* c;        // (T, NM, B)
  const float* x_init;   // (N, B)
  const float* u_lower;  // (T, M, B)
  const float* u_upper;  // (T, M, B)
  const float* u_init;   // (T, M, B), or null for a cold start
  // outputs
  float* xs;                // (T, N, B) best trajectory
  float* us;                // (T, M, B)
  float* objs;              // (B,)
  float* converged;         // (B,) 1.0 / 0.0
  float* last_improvement;  // (B,)
  float* alpha;             // (B,)
  float* n_iters;           // (B,)
  float* qp_iters;          // (B,)
  // scratch
  float* x_hat;  // (T, N, B) current trajectory
  float* u_hat;  // (T, M, B)
  float* K;      // (T, M, N, B) feedback gains
  float* k;      // (T, M, B) feedforward gains
  int T;
  int B;
  int params_stride;
  int lqr_iter;
  int n_alpha;
  int not_improved_lim;
  int has_delta_u;
  float reg;
  float decay;
  float alpha_floor;  // decay ** (n_alpha - 1): the ladder's pick when no step improves
  float delta_u;
  float eps;
  float best_cost_eps;
  // scratch of the HoistLin pre-pass, null without it
  float* F_s;   // (T, N, NM, B) the steps' Jacobians
  float* cd_s;  // (T, NM, B) their delta costs c + C tau_hat
};

namespace ilqr_detail {

// element (t, i) of a batch-minor (T, D, B) array, for scenario b
DMPC_HD size_t at(int t, int i, int D, int B, int b) {
  return ((size_t)t * D + i) * (size_t)B + b;
}

// 0.5 tau'C_t tau + c_t'tau, summed in the TPU kernel's order (stage_cost)
template <int N, int M>
DMPC_HD float stage_cost(const IlqrArgs& a, int t, int b, const float (&x)[N], const float (&u)[M]) {
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

// u = u_hat + alpha k + K (x - x_hat), then the delta_u clip, then the box
template <int N, int M>
DMPC_HD void control(const IlqrArgs& a, int t, int b, const float (&x)[N], float alpha, float (&u)[M]) {
  const int B = a.B;
  for (int i = 0; i < M; ++i) {
    const float uh = a.u_hat[at(t, i, M, B, b)];
    float acc = uh + alpha * a.k[at(t, i, M, B, b)];
    for (int j = 0; j < N; ++j)
      acc = acc + a.K[at(t, i * N + j, M * N, B, b)] * (x[j] - a.x_hat[at(t, j, N, B, b)]);
    if (a.has_delta_u) acc = clipf(acc, uh - a.delta_u, uh + a.delta_u);
    u[i] = clipf(acc, a.u_lower[at(t, i, M, B, b)], a.u_upper[at(t, i, M, B, b)]);
  }
}

// cost of the closed-loop rollout at step size alpha (nothing stored)
template <int N, int M, class Env>
DMPC_HD float rollout_obj(const IlqrArgs& a, const Env& env, const float* p, int b,
                          const float (&x0)[N], float alpha) {
  float x[N], u[M], xn[N];
  for (int i = 0; i < N; ++i) x[i] = x0[i];
  float obj = 0.0f;
  for (int t = 0; t < a.T; ++t) {
    control<N, M>(a, t, b, x, alpha, u);
    obj += stage_cost<N, M>(a, t, b, x, u);
    env.step(p, x, u, xn);
    for (int i = 0; i < N; ++i) x[i] = xn[i];
  }
  return obj;
}

// Step t's Jacobian Ft[k][j] = d x_next[k] / d tau[j] at (x_hat, u_hat), by
// one pass of the step on dual numbers (column j of [A B] is the tangent of
// seed e_j), and its delta-form linear cost cd = c + C tau_hat. Neither
// reads the value carry.
template <int N, int M, class Env>
DMPC_HD void linearize_at(const IlqrArgs& a, const Env& env, const float* p, int b, int t,
                          float (&Ft)[N][N + M], float (&cd)[N + M]) {
  constexpr int NM = N + M;
  const int B = a.B;
  Dual<float, NM> xd[N], ud[M], outd[N];
  float tau[NM];
  for (int i = 0; i < N; ++i) {
    tau[i] = a.x_hat[at(t, i, N, B, b)];
    xd[i] = Dual<float, NM>::seed(tau[i], i);
  }
  for (int i = 0; i < M; ++i) {
    tau[N + i] = a.u_hat[at(t, i, M, B, b)];
    ud[i] = Dual<float, NM>::seed(tau[N + i], N + i);
  }
  env.step(p, xd, ud, outd);
  for (int k = 0; k < N; ++k)
    for (int j = 0; j < NM; ++j) Ft[k][j] = outd[k].d[j];
  for (int i = 0; i < NM; ++i) {
    float s2 = 0.0f;
    for (int j = 0; j < NM; ++j) s2 += a.C[at(t, i * NM + j, NM * NM, B, b)] * tau[j];
    cd[i] = a.c[at(t, i, NM, B, b)] + s2;
  }
}

// Delta-form Riccati sweep over t = T-1..0 about (x_hat, u_hat): writes the
// gains K, k and returns the summed box-QP solve count. With HoistLin, a
// pre-pass first writes every step's Ft, cd to F_s, cd_s.
template <int N, int M, bool HoistLin, class Env>
DMPC_HD float riccati_sweep(const IlqrArgs& a, const Env& env, const float* p, int b) {
  constexpr int NM = N + M;
  const int B = a.B;
  if constexpr (HoistLin) {
    for (int t = 0; t < a.T; ++t) {  // independent iterations
      float Ft[N][NM], cd[NM];
      linearize_at<N, M>(a, env, p, b, t, Ft, cd);
      for (int k = 0; k < N; ++k)
        for (int j = 0; j < NM; ++j) a.F_s[at(t, k * NM + j, N * NM, B, b)] = Ft[k][j];
      for (int i = 0; i < NM; ++i) a.cd_s[at(t, i, NM, B, b)] = cd[i];
    }
  }
  float V[N][N], v[N];
  for (int i = 0; i < N; ++i) {
    v[i] = 0.0f;
    for (int j = 0; j < N; ++j) V[i][j] = 0.0f;
  }
  float qp_sum = 0.0f;
  for (int s = 0; s < a.T; ++s) {
    const int t = a.T - 1 - s;
    float Ft[N][NM], cd[NM], Ct[NM][NM], uh[M];
    if constexpr (HoistLin) {
      for (int k = 0; k < N; ++k)
        for (int j = 0; j < NM; ++j) Ft[k][j] = a.F_s[at(t, k * NM + j, N * NM, B, b)];
      for (int i = 0; i < NM; ++i) cd[i] = a.cd_s[at(t, i, NM, B, b)];
    } else {
      linearize_at<N, M>(a, env, p, b, t, Ft, cd);
    }
    for (int i = 0; i < M; ++i) uh[i] = a.u_hat[at(t, i, M, B, b)];
    for (int i = 0; i < NM; ++i)
      for (int j = 0; j < NM; ++j) Ct[i][j] = a.C[at(t, i * NM + j, NM * NM, B, b)];
    // W = V F ; Q = C + F'W (upper triangle of C, mirrored) ; q = cd + F'v
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
        Q[i][j] = Ct[i][j] + s2;
        Q[j][i] = Q[i][j];
      }
    for (int i = 0; i < NM; ++i) {
      float s2 = 0.0f;
      for (int k = 0; k < N; ++k) s2 += Ft[k][i] * v[k];
      q[i] = cd[i] + s2;
    }
    float Quu[M][M], qu[M], lo_d[M], hi_d[M], rhs[N][M];
    for (int i = 0; i < M; ++i) {
      for (int j = 0; j < M; ++j) Quu[i][j] = Q[N + i][N + j];
      qu[i] = q[N + i];
      lo_d[i] = a.u_lower[at(t, i, M, B, b)] - uh[i];
      hi_d[i] = a.u_upper[at(t, i, M, B, b)] - uh[i];
      for (int j = 0; j < N; ++j) rhs[j][i] = Q[N + i][j];  // column j of Qux
    }
    float kt[M], frozen[M], Kc[N][M], K[M][N];
    // n_iter 8: the fused path caps pnqp_iter at 8 (mpc.py); only m >= 3 reads it
    qp_sum += pnqp_entries<M>(Quu, qu, lo_d, hi_d, 8, a.reg, kt, frozen);
    masked_chol_solve<M, N>(Quu, rhs, frozen, a.reg, Kc);
    for (int i = 0; i < M; ++i) {
      for (int j = 0; j < N; ++j) {
        K[i][j] = -Kc[j][i];
        a.K[at(t, i * N + j, M * N, B, b)] = K[i][j];
      }
      a.k[at(t, i, M, B, b)] = kt[i];
    }
    value_update<N, M>(Q, q, Quu, qu, K, kt, V, v);
  }
  return qp_sum;
}

}  // namespace ilqr_detail

// Solve scenario b, its env's parameters read from `params` (a.params, or a
// block's copy of them in shared memory). Early exit is per scenario: the
// TPU kernel skips an iteration only once the whole tile is frozen (pl.when
// at ilqr.py:431), but every update of a frozen scenario there is
// where(active > 0, new, old) (:381-410), which leaves it unchanged, and its
// K, k are never read again. So a thread that stops at its own convergence
// computes exactly the same result.
template <int N, int M, bool HoistLin = false, class Env>
DMPC_HD void ilqr_solve_scenario(const IlqrArgs& a, const Env& env, int b, const float* params) {
  using namespace ilqr_detail;
  const int T = a.T, B = a.B;
  const float* p = params + (size_t)b * a.params_stride;
  float x0[N];
  for (int i = 0; i < N; ++i) x0[i] = a.x_init[(size_t)i * B + b];

  // initial trajectory: u_init (or zero) clamped into the box
  float x[N], u[M], xn[N];
  for (int i = 0; i < N; ++i) x[i] = x0[i];
  float obj = 0.0f;
  for (int t = 0; t < T; ++t) {
    for (int i = 0; i < M; ++i) {
      const float ui = a.u_init ? a.u_init[at(t, i, M, B, b)] : 0.0f;
      u[i] = clipf(ui, a.u_lower[at(t, i, M, B, b)], a.u_upper[at(t, i, M, B, b)]);
    }
    for (int i = 0; i < N; ++i) a.x_hat[at(t, i, N, B, b)] = a.xs[at(t, i, N, B, b)] = x[i];
    for (int i = 0; i < M; ++i) a.u_hat[at(t, i, M, B, b)] = a.us[at(t, i, M, B, b)] = u[i];
    obj += stage_cost<N, M>(a, t, b, x, u);
    env.step(p, x, u, xn);
    for (int i = 0; i < N; ++i) x[i] = xn[i];
  }
  float cur_obj = obj, best_obj = obj;
  float n_not_improved = 0.0f, last_improvement = INFINITY, last_alpha = 1.0f;
  float n_iters = 0.0f, qp_iters = 0.0f;
  bool done = false;

  for (int it = 0; it < a.lqr_iter && !done; ++it) {
    qp_iters = riccati_sweep<N, M, HoistLin>(a, env, p, b) / (float)T;

    // rolled alpha ladder: first improving step, else alpha_floor
    float alpha = 1.0f, chosen = a.alpha_floor;
    bool has = false;
    for (int ai = 0; ai < a.n_alpha; ++ai) {
      const float obj_a = rollout_obj<N, M>(a, env, p, b, x0, alpha);
      if (obj_a < cur_obj && !has) {
        chosen = alpha;
        has = true;
      }
      alpha = alpha * a.decay;
    }

    // replay the chosen step, writing the new trajectory
    for (int i = 0; i < N; ++i) x[i] = x0[i];
    float new_obj = 0.0f;
    for (int t = 0; t < T; ++t) {
      control<N, M>(a, t, b, x, chosen, u);
      for (int i = 0; i < N; ++i) a.x_hat[at(t, i, N, B, b)] = x[i];
      for (int i = 0; i < M; ++i) a.u_hat[at(t, i, M, B, b)] = u[i];
      new_obj += stage_cost<N, M>(a, t, b, x, u);
      env.step(p, x, u, xn);
      for (int i = 0; i < N; ++i) x[i] = xn[i];
    }
    cur_obj = new_obj;

    const bool improved = new_obj < best_obj;
    const bool improved_sig = new_obj < best_obj - a.best_cost_eps;
    const float improvement = best_obj - new_obj;
    if (improved) {
      for (int t = 0; t < T; ++t) {
        for (int i = 0; i < N; ++i) a.xs[at(t, i, N, B, b)] = a.x_hat[at(t, i, N, B, b)];
        for (int i = 0; i < M; ++i) a.us[at(t, i, M, B, b)] = a.u_hat[at(t, i, M, B, b)];
      }
      best_obj = new_obj;
    }
    n_not_improved = improved_sig ? 0.0f : n_not_improved + 1.0f;
    last_improvement = improvement;
    last_alpha = chosen;
    n_iters += 1.0f;
    done = (improvement < a.eps) || (n_not_improved >= (float)a.not_improved_lim);
  }

  a.objs[b] = best_obj;
  a.converged[b] = last_improvement < a.eps ? 1.0f : 0.0f;
  a.last_improvement[b] = last_improvement;
  a.alpha[b] = last_alpha;
  a.n_iters[b] = n_iters;
  a.qp_iters[b] = qp_iters;
}

template <int N, int M, bool HoistLin = false, class Env>
DMPC_HD void ilqr_solve_scenario(const IlqrArgs& a, const Env& env, int b) {
  ilqr_solve_scenario<N, M, HoistLin>(a, env, b, a.params);
}
