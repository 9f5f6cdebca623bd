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
// The sweep runs as the fused kernel's sweep runs (ilqr.cuh, riccati_sweep):
// a group of L lanes per scenario (lanes.cuh; L in 1, 2, 4, 16), every lane
// running the step on the same values in lockstep, step t's K, k stored by
// lane t % L. Two read modes, both built (PieceArgs::staged):
//   device memory: every lane loads each step's C, c, x_hat, u_hat, lo, hi
//     at the step, inside the value carry's chain, as riccati_sweep does;
//   staged: each step's slice (PieceSlice) is copied once per group by
//     cp.async into a ring of kLaneStages shared-memory slots,
//     kLaneStages - 1 steps ahead of the step the group computes, the
//     entries split over the lanes by a plan worked out once (PiecePlan;
//     stream.cuh), and read back by every lane.
// The rollout runs on the same groups and reads the same slice
// (PieceSlice) in the same two modes, walking forward in t (PieceRing): every
// lane runs the whole chain, as the line search's lanes replay the accepted
// step (rollout.cuh), and the group's first lane writes the objective.
// Every L and both modes compute the same float32 operations on the same
// values as L = 1 reading device memory: bit for bit the same outputs. The
// gap between the two modes' times is what the loads' latency on the chain
// costs the sweep or the rollout.
//
// csrc/riccati_pieces.cu runs these on the card (the kernels built one file
// per lane count, riccati_pieces_l<L>.cu, riccati_pieces_launch.cuh); the
// tests build them with g++ for the host, where the lanes of a group run one
// after another (HostLanes); diffmpc_tpu_torch/ops/cuda/riccati_pieces.py
// holds the plain PyTorch version of each.
//
// Layout: every per-step array is batch-minor, (T, entries..., B).
#pragma once

#include "dual.cuh"
#include "lanes.cuh"
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
  float reg;   // the sweep's box QP and masked solve (the script's 1e-7)
  int lanes;   // threads per scenario, L
  int staged;  // 1 reads each step's slice from the group's staging ring, 0 device memory
};

namespace pieces_detail {

constexpr int N = 3, M = 1, NM = 4;

// element (t, i) of a batch-minor (T, D, B) array, for scenario b
DMPC_HD size_t at(int t, int i, int D, int B, int b) {
  return ((size_t)t * D + i) * (size_t)B + b;
}

// One step's slice of the sweep and the rollout: C (all 16 entries: C
// tau_hat, the no_Qform stand-in and the stage cost read its rows), c,
// x_hat, u_hat, lo, hi.
struct PieceSlice {
  static constexpr int kC = 0, kc = NM * NM, kxh = kc + NM, kuh = kxh + N, klo = kuh + M, khi = klo + M;
  static constexpr int kSize = khi + M;
};

// Step t's inputs from device memory.
struct PieceGlobal {
  const PieceArgs& a;
  int t;
  int b;
  DMPC_HD float C(int i, int j) const { return a.C[at(t, i * NM + j, NM * NM, a.B, b)]; }
  DMPC_HD float c(int i) const { return a.c[at(t, i, NM, a.B, b)]; }
  DMPC_HD float xh(int i) const { return a.x_hat[at(t, i, N, a.B, b)]; }
  DMPC_HD float uh(int i) const { return a.u_hat[at(t, i, M, a.B, b)]; }
  DMPC_HD float lo(int i) const { return a.lo[at(t, i, M, a.B, b)]; }
  DMPC_HD float hi(int i) const { return a.hi[at(t, i, M, a.B, b)]; }
};

// Step t's inputs from the group's staging slot.
struct PieceSlot {
  SlotReader e;
  DMPC_HD float C(int i, int j) const { return e[PieceSlice::kC + i * NM + j]; }
  DMPC_HD float c(int i) const { return e[PieceSlice::kc + i]; }
  DMPC_HD float xh(int i) const { return e[PieceSlice::kxh + i]; }
  DMPC_HD float uh(int i) const { return e[PieceSlice::kuh + i]; }
  DMPC_HD float lo(int i) const { return e[PieceSlice::klo + i]; }
  DMPC_HD float hi(int i) const { return e[PieceSlice::khi + i]; }
};

// Copy step t's slice into `slot` whole (a group of one lane), as one group
// of copies.
DMPC_HD void piece_stage(const PieceArgs& a, int stride, int t, int b, float* slot) {
  const int B = a.B;
  for (int e = 0; e < NM * NM; ++e) stream_put(slot, stride, PieceSlice::kC + e, &a.C[at(t, e, NM * NM, B, b)]);
  for (int i = 0; i < NM; ++i) stream_put(slot, stride, PieceSlice::kc + i, &a.c[at(t, i, NM, B, b)]);
  for (int i = 0; i < N; ++i) stream_put(slot, stride, PieceSlice::kxh + i, &a.x_hat[at(t, i, N, B, b)]);
  for (int i = 0; i < M; ++i) {
    stream_put(slot, stride, PieceSlice::kuh + i, &a.u_hat[at(t, i, M, B, b)]);
    stream_put(slot, stride, PieceSlice::klo + i, &a.lo[at(t, i, M, B, b)]);
    stream_put(slot, stride, PieceSlice::khi + i, &a.hi[at(t, i, M, B, b)]);
  }
  stream_commit();
}

// A lane's share of each step's slice above one lane: its entries
// e = lane, lane + L, ..., each as its source at step 0 and the floats
// between two steps' sources, worked out once, so that a step's copies cost
// the lane its own entries alone (one lane copies the slice whole, by
// piece_stage).
template <int L>
struct PiecePlan {
  static constexpr int kMine = (PieceSlice::kSize + L - 1) / L;
  const float* src[kMine];
  int step[kMine];
  DMPC_HD void init(const PieceArgs& a, int lane, int b) {
    const int B = a.B;
    for (int k = 0; k < kMine; ++k) {
      const int e = lane + k * L;
      if (e < PieceSlice::kc) {
        src[k] = &a.C[at(0, e, NM * NM, B, b)];
        step[k] = NM * NM * B;
      } else if (e < PieceSlice::kxh) {
        src[k] = &a.c[at(0, e - PieceSlice::kc, NM, B, b)];
        step[k] = NM * B;
      } else if (e < PieceSlice::kuh) {
        src[k] = &a.x_hat[at(0, e - PieceSlice::kxh, N, B, b)];
        step[k] = N * B;
      } else if (e < PieceSlice::kSize) {
        const float* arr = e < PieceSlice::klo ? a.u_hat : e < PieceSlice::khi ? a.lo : a.hi;
        src[k] = &arr[b];
        step[k] = M * B;
      } else {
        src[k] = nullptr;
        step[k] = 0;
      }
    }
  }
};

// Copy step t's slice into `slot` by the plans of the group's lanes, as one
// group of copies.
template <class G, class Plan>
DMPC_HD void piece_stage_planned(const G& g, const Plan (&plan)[G::kLocal], int t, float* slot) {
  constexpr int L = G::kLanes;
  for (int li = 0; li < G::kLocal; ++li)
    for (int k = 0; k < Plan::kMine; ++k) {
      const int e = g.lane_of(li) + k * L;
      if (e < PieceSlice::kSize) stream_put(slot, g.stride, e, plan[li].src[k] + (size_t)t * plan[li].step[k]);
    }
  stream_commit();
}

// Step t's inputs as riccati_q_form (riccati.cuh) reads them: C from the
// step's inputs, the delta cost cd = c + C tau_hat in place of c, the
// Jacobian F, and no f: the serial sweep's Q form about the trajectory.
template <class In>
struct StepModel {
  const In& in;
  const float (&Ft)[N][NM];
  const float (&cd)[NM];
  DMPC_HD float C(int i, int j) const { return in.C(i, j); }
  DMPC_HD float c(int i) const { return cd[i]; }
  DMPC_HD float F(int i, int j) const { return Ft[i][j]; }
  DMPC_HD bool has_f() const { return false; }
  DMPC_HD float f(int) const { return 0.0f; }
};

// One step t of the sweep (ric_body) in variant VARIANT from its inputs
// `in`: writes K, k at t where `mine` and updates the value carry (V, v) in
// place.
template <int VARIANT, class In>
DMPC_HD void sweep_step(const PieceArgs& a, const PendulumEnv& env, const In& in, int t, int b, bool mine,
                        float (&V)[N][N], float (&v)[N]) {
  const int B = a.B;
  float tau[NM];
  for (int i = 0; i < N; ++i) tau[i] = in.xh(i);
  for (int i = 0; i < M; ++i) tau[N + i] = in.uh(i);
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
    for (int j = 0; j < NM; ++j) s += in.C(i, j) * tau[j];
    cd[i] = in.c(i) + s;
  }
  float Q[NM][NM], q[NM];
  if constexpr (VARIANT == kPieceNoQform) {
    for (int i = 0; i < NM; ++i) {
      for (int j = 0; j < NM; ++j) Q[i][j] = in.C(i, j) + (i == j ? V[0][0] * 1e-6f : 0.0f);
      q[i] = cd[i] + Ft[0][i] * 1e-6f;
    }
  } else {
    riccati_q_form<N, M>(StepModel<In>{in, Ft, cd}, V, v, Q, q);
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
      lo_d[i] = in.lo(i) - tau[N + i];
      hi_d[i] = in.hi(i) - tau[N + i];
    }
    pnqp_entries<M>(Quu, qu, lo_d, hi_d, 8, a.reg, kt, frozen);
    masked_chol_solve<M, N>(Quu, cols, frozen, a.reg, Kc);
    for (int i = 0; i < M; ++i)
      for (int j = 0; j < N; ++j) K[i][j] = -Kc[j][i];
  }
  if (mine) {
    for (int i = 0; i < M; ++i) {
      for (int j = 0; j < N; ++j) a.K[at(t, i * N + j, M * N, B, b)] = K[i][j];
      a.k[at(t, i, M, B, b)] = kt[i];
    }
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

// Floats of shared memory a group's staging ring takes.
DMPC_HD constexpr int piece_group_slot_floats() { return kLaneStages * pieces_detail::PieceSlice::kSize; }

namespace pieces_detail {

// The step inputs of one scenario b for the group of lanes g (HostLanes or
// CardLanes), read from device memory at each step or, Staged, through the
// group's ring (g's slots): each step's slice copied kLaneStages - 1 steps
// ahead of the step the group computes, one lane whole by piece_stage, more
// lanes each its share by its plan (worked out once, here).
template <bool Staged, class G>
struct PieceRing {
  static constexpr int L = G::kLanes;
  const PieceArgs& a;
  const G& g;
  int b;
  PiecePlan<L> plan[G::kLocal];
  DMPC_HD PieceRing(const PieceArgs& a_, const G& g_, int b_) : a(a_), g(g_), b(b_) {
    if constexpr (Staged && L > 1)
      for (int li = 0; li < G::kLocal; ++li) plan[li].init(a, g.lane_of(li), b);
  }
  DMPC_HD void stage(int t, float* slot) const {
    if constexpr (L == 1)
      piece_stage(a, g.stride, t, b, slot);
    else
      piece_stage_planned(g, plan, t, slot);
  }
  // One pass over the T steps in the order t_of(0), t_of(1), ...:
  // step(in, t) with step t's inputs `in` (PieceGlobal or PieceSlot).
  template <class Order, class Step>
  DMPC_HD void walk(Order t_of, Step&& step) const {
    constexpr int kSize = PieceSlice::kSize, kStages = kLaneStages;
    const int T = a.T;
    if constexpr (!Staged) {
      for (int s = 0; s < T; ++s) {
        const int t = t_of(s);
        step(PieceGlobal{a, t, b}, t);
      }
    } else {
      g.sync();  // every lane is done with the last pass's slots
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < T) stage(t_of(s), stage_slot(g, s, kSize, kStages));
        else stream_commit();
      }
      for (int s = 0; s < T; ++s) {
        stream_wait<kStages - 2>();  // this lane's copies of step s
        g.sync();                    // and every other lane's; every lane is done with step s - 1's slot
        const int ahead = s + kStages - 1;
        if (ahead < T) stage(t_of(ahead), stage_slot(g, ahead, kSize, kStages));
        else stream_commit();
        step(PieceSlot{SlotReader{stage_slot(g, s, kSize, kStages), g.stride}}, t_of(s));
      }
    }
  }
};

// One step t of the rollout from its inputs `in`: the control from the
// state x, the stage cost (returned), and x moved on by the pendulum's step
// with `params` (g, m, l).
template <class In>
DMPC_HD float rollout_step(const PendulumEnv& env, const float* params, const In& in, float (&x)[N]) {
  float u[M], xn[N];
  for (int i = 0; i < M; ++i) {
    float acc = in.uh(i) + 0.5f * in.c(N + i);
    for (int j = 0; j < N; ++j) acc = acc + in.C(N + i, j) * (x[j] - in.xh(j));
    u[i] = clipf(acc, in.lo(i), in.hi(i));
  }
  float tau[NM];
  for (int i = 0; i < N; ++i) tau[i] = x[i];
  for (int i = 0; i < M; ++i) tau[N + i] = u[i];
  float acc = 0.0f;
  for (int i = 0; i < NM; ++i) {
    float Ctau = 0.0f;
    for (int j = 0; j < NM; ++j) Ctau += in.C(i, j) * tau[j];
    acc += (0.5f * Ctau + in.c(i)) * tau[i];
  }
  env.step(params, x, u, xn);
  for (int i = 0; i < N; ++i) x[i] = xn[i];
  return acc;
}

}  // namespace pieces_detail

// The sweep kernel's scenario b by the group of lanes g (HostLanes or
// CardLanes): reps sweeps over t = T-1..0, each seeded by the last one's
// V[0][0] (times 1e-30), then that seed folded into k[0] (times 1e-30) so
// that the chain's end is an output. Staged: each step's inputs read from
// the group's ring (g's slots), filled kLaneStages - 1 steps ahead.
template <int VARIANT, bool Staged, class G>
DMPC_HD void piece_sweep_scenario(const PieceArgs& a, const PendulumEnv& env, int b, const G& g) {
  using namespace pieces_detail;
  const PieceRing<Staged, G> ring(a, g, b);
  const int T = a.T;
  float seed = 0.0f;
  for (int r = 0; r < a.reps; ++r) {
    const float init = seed * 1e-30f;
    float V[N][N], v[N];
    for (int i = 0; i < N; ++i) {
      v[i] = init;
      for (int j = 0; j < N; ++j) V[i][j] = init;
    }
    ring.walk([T](int s) { return T - 1 - s; },
              [&](const auto& in, int t) { sweep_step<VARIANT>(a, env, in, t, b, g.owns(t), V, v); });
    seed = V[0][0];
  }
  if (g.owns(0)) {  // the lane that stored step 0
    float& k0 = a.k[at(0, 0, M, a.B, b)];
    k0 = k0 + seed * 1e-30f;
  }
}

// The rollout kernel's scenario b by the group of lanes g: reps closed-loop
// rollouts of T steps, u = clip(u_hat + 0.5 c_u + C_ux (x - x_hat), lo, hi)
// (the cost's entries stand in for the gains), the stage cost summed, each
// rollout seeded by the last one's objective (times 1e-30). Every lane runs
// the whole chain on the same values in lockstep, as the line search's lanes
// replay the accepted step (rollout.cuh), so every L gives L = 1's bits;
// the group's first lane writes the last objective. Staged: each step's
// inputs read from the group's ring, filled kLaneStages - 1 steps ahead.
template <bool Staged, class G>
DMPC_HD void piece_rollout_scenario(const PieceArgs& a, const PendulumEnv& env, int b, const G& g) {
  using namespace pieces_detail;
  const PieceRing<Staged, G> ring(a, g, b);
  // Staged, the pendulum's params are read once into registers: the
  // copies' cp.async statements order memory, so a step would otherwise load
  // them again after its copies. Reading device memory, each step loads them
  // beside its slice, as the sweep's step does: loaded once before the loop,
  // this mode ran slower on the card (PERF.md, row 9b).
  const float regs[3] = {a.params[0], a.params[1], a.params[2]};
  const float* params = Staged ? regs : a.params;
  float seed = 0.0f;
  for (int r = 0; r < a.reps; ++r) {
    float x[N];
    for (int i = 0; i < N; ++i) x[i] = a.x_hat[at(0, i, N, a.B, b)] + seed * 1e-30f;
    float obj = seed * 1e-30f;
    ring.walk([](int s) { return s; }, [&](const auto& in, int) { obj = obj + rollout_step(env, params, in, x); });
    seed = obj;
  }
  if (g.leader()) a.obj[b] = seed;
}
