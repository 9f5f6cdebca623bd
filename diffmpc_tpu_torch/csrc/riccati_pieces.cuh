// The piece-decomposition kernels of the fused iLQR sweep, for ONE scenario.
//
// Counterparts of the two kernel makers of scripts/profile_riccati_pieces.py:
// make_sweep_kernel (:52-178), the fused iLQR kernel's delta-form Riccati
// step (ric_body, :64-166) with one piece stubbed, and make_rollout_kernel
// (:181-216), a T-step closed-loop rollout that anchors the cost of one
// dependent step. Both run on the pendulum (n = 3, m = 1). Each repeats its
// sweep or rollout `reps` times, the repetitions chained by a seed (rep r
// starts from rep r-1's result times 1e-30), so that no compiler can hoist
// or drop one; the cost of one sweep is then the slope
// (t[reps=9] - t[reps=1]) / 8, and reps is a runtime argument, so both rep
// counts run the same binary.
//
// The sweep's variants (enum PieceVariant), each with the script's stand-ins
// exactly, so that no piece becomes dead code:
//   full:      the step as ilqr.cuh riccati_sweep runs it: the Jacobian by
//              Dual<float, 4> through pendulum.cuh, the Q form (the serial
//              sweep's riccati_q_form), the box QP (pnqp_entries) and the
//              masked solve, the full value update;
//   no_lin:    F[k][j] = V[k][k] 1e-6 + (j == k) in place of the Jacobian;
//   no_Qform:  Q = C + V[0][0] 1e-6 I, q = c + C tau_hat + F[0] 1e-6;
//   no_pnqp:   k = -qu / (Quu + 1e-7), K = -Qux / (Quu + 1e-7);
//   no_Vup:    V' = V + k 1e-9 I, v' = v + K' 1e-9.
//
// csrc/riccati_pieces.cu runs these with one thread per scenario; the tests
// build them with g++ for the host; diffmpc_tpu_torch/ops/cuda/
// riccati_pieces.py holds the plain PyTorch version of each.
//
// Layout: every per-step array is batch-minor, (T, entries..., B).
#pragma once

#include "dual.cuh"
#include "pendulum.cuh"
#include "riccati.cuh"

enum PieceVariant { kPieceFull = 0, kPieceNoLin = 1, kPieceNoQform = 2, kPieceNoPnqp = 3, kPieceNoVup = 4 };

// Launch arguments. The field order is mirrored by ctypes in
// diffmpc_tpu_torch/ops/cuda/riccati_pieces.py (_PieceArgs): keep the two in
// step.
struct PieceArgs {
  // inputs
  const float* params;  // (3,) the pendulum's (g, m, l)
  const float* C;       // (T, 4, 4, B)
  const float* c;       // (T, 4, B)
  const float* x_hat;   // (T, 3, B)
  const float* u_hat;   // (T, 1, B)
  const float* lo;      // (T, 1, B) the box, absolute (the sweep takes lo - u_hat)
  const float* hi;      // (T, 1, B)
  // outputs
  float* K;    // (T, 1, 3, B) the sweep's gains (its last rep)
  float* k;    // (T, 1, B)
  float* obj;  // (B,) the rollout's objective (its last rep)
  int T;
  int B;
  int reps;
  float reg;  // the sweep's box QP and masked solve (the script's 1e-7)
};

namespace pieces_detail {

constexpr int N = 3, M = 1, NM = 4;

// element (t, i) of a batch-minor (T, D, B) array, for scenario b
DMPC_HD size_t at(int t, int i, int D, int B, int b) {
  return ((size_t)t * D + i) * (size_t)B + b;
}

// Step t's inputs as riccati_q_form (riccati.cuh) reads them: C from device
// memory, the delta cost cd = c + C tau_hat in place of c, the Jacobian F,
// and no f: the serial sweep's Q form about the trajectory.
struct StepModel {
  const PieceArgs& a;
  int t;
  int b;
  const float (&Ft)[N][NM];
  const float (&cd)[NM];
  DMPC_HD float C(int i, int j) const { return a.C[at(t, i * NM + j, NM * NM, a.B, b)]; }
  DMPC_HD float c(int i) const { return cd[i]; }
  DMPC_HD float F(int i, int j) const { return Ft[i][j]; }
  DMPC_HD bool has_f() const { return false; }
  DMPC_HD float f(int) const { return 0.0f; }
};

// One step t of the sweep (ric_body) in variant VARIANT: writes K, k at t
// and updates the value carry (V, v) in place.
template <int VARIANT>
DMPC_HD void sweep_step(const PieceArgs& a, const PendulumEnv& env, int t, int b, float (&V)[N][N], float (&v)[N]) {
  const int B = a.B;
  float tau[NM];
  for (int i = 0; i < N; ++i) tau[i] = a.x_hat[at(t, i, N, B, b)];
  for (int i = 0; i < M; ++i) tau[N + i] = a.u_hat[at(t, i, M, B, b)];
  float Ft[N][NM];
  if constexpr (VARIANT == kPieceNoLin) {
    for (int k = 0; k < N; ++k)
      for (int j = 0; j < NM; ++j) Ft[k][j] = V[k][k] * 1e-6f + (j == k ? 1.0f : 0.0f);
  } else {
    // column j of [A B] is the tangent of seed e_j
    Dual<float, NM> xd[N], ud[M], outd[N];
    for (int i = 0; i < N; ++i) xd[i] = Dual<float, NM>::seed(tau[i], i);
    for (int i = 0; i < M; ++i) ud[i] = Dual<float, NM>::seed(tau[N + i], N + i);
    env.step(a.params, xd, ud, outd);
    for (int k = 0; k < N; ++k)
      for (int j = 0; j < NM; ++j) Ft[k][j] = outd[k].d[j];
  }
  // delta-form linear cost cd = c + C tau_hat
  float cd[NM];
  for (int i = 0; i < NM; ++i) {
    float s = 0.0f;
    for (int j = 0; j < NM; ++j) s += a.C[at(t, i * NM + j, NM * NM, B, b)] * tau[j];
    cd[i] = a.c[at(t, i, NM, B, b)] + s;
  }
  float Q[NM][NM], q[NM];
  if constexpr (VARIANT == kPieceNoQform) {
    for (int i = 0; i < NM; ++i) {
      for (int j = 0; j < NM; ++j) Q[i][j] = a.C[at(t, i * NM + j, NM * NM, B, b)] + (i == j ? V[0][0] * 1e-6f : 0.0f);
      q[i] = cd[i] + Ft[0][i] * 1e-6f;
    }
  } else {
    riccati_q_form<N, M>(StepModel{a, t, b, Ft, cd}, V, v, Q, q);
  }
  float Quu[M][M], qu[M], cols[N][M];
  riccati_control_blocks<N, M>(Q, q, Quu, qu, cols);
  float K[M][N], kt[M];
  if constexpr (VARIANT == kPieceNoPnqp) {
    const float inv = 1.0f / (Quu[0][0] + 1e-7f);
    kt[0] = -qu[0] * inv;
    for (int j = 0; j < N; ++j) K[0][j] = -cols[j][0] * inv;
  } else {
    float lo_d[M], hi_d[M], frozen[M], Kc[N][M];
    for (int i = 0; i < M; ++i) {
      lo_d[i] = a.lo[at(t, i, M, B, b)] - tau[N + i];
      hi_d[i] = a.hi[at(t, i, M, B, b)] - tau[N + i];
    }
    pnqp_entries<M>(Quu, qu, lo_d, hi_d, 8, a.reg, kt, frozen);
    masked_chol_solve<M, N>(Quu, cols, frozen, a.reg, Kc);
    for (int i = 0; i < M; ++i)
      for (int j = 0; j < N; ++j) K[i][j] = -Kc[j][i];
  }
  for (int i = 0; i < M; ++i) {
    for (int j = 0; j < N; ++j) a.K[at(t, i * N + j, M * N, B, b)] = K[i][j];
    a.k[at(t, i, M, B, b)] = kt[i];
  }
  if constexpr (VARIANT == kPieceNoVup) {
    for (int i = 0; i < N; ++i) {
      for (int j = 0; j < N; ++j) V[i][j] = V[i][j] + (i == j ? kt[0] * 1e-9f : 0.0f);
      v[i] = v[i] + K[0][i] * 1e-9f;
    }
  } else {
    value_update<N, M>(Q, q, Quu, qu, K, kt, V, v);
  }
}

}  // namespace pieces_detail

// The sweep kernel's scenario b: reps sweeps over t = T-1..0, each seeded by
// the last one's V[0][0] (times 1e-30), then that seed folded into k[0]
// (times 1e-30) so that the chain's end is an output.
template <int VARIANT>
DMPC_HD void piece_sweep_scenario(const PieceArgs& a, const PendulumEnv& env, int b) {
  using namespace pieces_detail;
  float seed = 0.0f;
  for (int r = 0; r < a.reps; ++r) {
    const float init = seed * 1e-30f;
    float V[N][N], v[N];
    for (int i = 0; i < N; ++i) {
      v[i] = init;
      for (int j = 0; j < N; ++j) V[i][j] = init;
    }
    for (int s = 0; s < a.T; ++s) sweep_step<VARIANT>(a, env, a.T - 1 - s, b, V, v);
    seed = V[0][0];
  }
  float& k0 = a.k[at(0, 0, M, a.B, b)];
  k0 = k0 + seed * 1e-30f;
}

// The rollout kernel's scenario b: reps closed-loop rollouts of T steps,
// u = clip(u_hat + 0.5 c_u + C_ux (x - x_hat), lo, hi) (the cost's entries
// stand in for the gains), the stage cost summed, each rollout seeded by the
// last one's objective (times 1e-30). Writes the last objective.
DMPC_HD void piece_rollout_scenario(const PieceArgs& a, const PendulumEnv& env, int b) {
  using namespace pieces_detail;
  const int B = a.B;
  float seed = 0.0f;
  for (int r = 0; r < a.reps; ++r) {
    float x[N], u[M], xn[N];
    for (int i = 0; i < N; ++i) x[i] = a.x_hat[at(0, i, N, B, b)] + seed * 1e-30f;
    float obj = seed * 1e-30f;
    for (int t = 0; t < a.T; ++t) {
      for (int i = 0; i < M; ++i) {
        float acc = a.u_hat[at(t, i, M, B, b)] + 0.5f * a.c[at(t, N + i, NM, B, b)];
        for (int j = 0; j < N; ++j)
          acc = acc + a.C[at(t, (N + i) * NM + j, NM * NM, B, b)] * (x[j] - a.x_hat[at(t, j, N, B, b)]);
        u[i] = clipf(acc, a.lo[at(t, i, M, B, b)], a.hi[at(t, i, M, B, b)]);
      }
      float tau[NM];
      for (int i = 0; i < N; ++i) tau[i] = x[i];
      for (int i = 0; i < M; ++i) tau[N + i] = u[i];
      float acc = 0.0f;
      for (int i = 0; i < NM; ++i) {
        float Ctau = 0.0f;
        for (int j = 0; j < NM; ++j) Ctau += a.C[at(t, i * NM + j, NM * NM, B, b)] * tau[j];
        acc += (0.5f * Ctau + a.c[at(t, i, NM, B, b)]) * tau[i];
      }
      obj = obj + acc;
      env.step(a.params, x, u, xn);
      for (int i = 0; i < N; ++i) x[i] = xn[i];
    }
    seed = obj;
  }
  a.obj[b] = seed;
}
