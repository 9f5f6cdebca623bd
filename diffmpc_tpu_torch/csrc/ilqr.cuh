// The whole box-constrained iLQR solve of ONE scenario, by a group of L lanes.
//
// Counterpart of the TPU kernel body _make_kernel in
// diffmpc_tpu/ops/pallas/ilqr.py (:89-455), computing what it computes,
// with a group of L threads (lanes.cuh: "lanes", L in 1, 2, 4, 16, all in
// one warp) in place of one lane of an (S, 128) tile. csrc/ilqr.cu and
// csrc/ilqr_nn_l<L>.cu run it on the card (ilqr_launch.cuh); the tests
// build it with g++ for the host, where the lanes of a group run one after
// another (HostLanes).
// diffmpc_tpu_torch/ops/cuda/ilqr.py (ilqr_solve_plain) is the same
// algorithm in plain PyTorch, vectorised over the batch.
//
// What the lanes share out, per iteration:
// - the alpha ladder: lane j rolls out candidates j, j + L, ..., all lanes
//   advancing step t together; the pick is the first strictly improving
//   candidate by ladder index (a ballot over the group, round by round when
//   n_alpha > L), else alpha_floor. The rolled ladder's alpha of candidate k
//   is 1 * decay * ... carried k times in float32, the serial loop's value;
//   with `alphas` (unroll) it is the wrapper's decay**k, rounded once.
// - each step's slice (C, c, K, k, x_hat, u_hat, the box) of the ladder's
//   and the replay's rollouts is copied once for the group into shared
//   memory, entries split over the lanes, kLaneStages - 1 steps ahead of
//   the step the group computes (stream.cuh's cp.async), and read back as a
//   broadcast;
// - the HoistLin pre-pass (the TPU kernel's hoist_lin=True, pre_body at
//   ilqr.py:234-249): lane j linearizes steps t = j, j + L, ... into the
//   scratch F_s, cd_s, so the Jacobian leaves the value carry's chain;
// - the new trajectory (where ilqr_keeps_lanes): until a candidate is
//   chosen, each lane keeps its candidate's trajectory in its own slot of
//   lane_x, lane_u, and the chosen lane's slot becomes (x_hat, u_hat), its
//   cost the new cost: the replay's values, without the replay's chain.
//   Only when no candidate improves is alpha_floor replayed;
// - the stores of every step-indexed array: step t by lane t % L;
// - with the shared sweep (Shared, riccati_sweep_shared: the variants,
//   csrc/variants/variant.cuh) at 16 lanes, the Riccati sweep itself: each
//   step's arithmetic is riccati.cuh's lane-group step (riccati_lanes_step:
//   Q's entries, the box QP's candidates, the gains' columns, V' and v'
//   shared out), and the steps' inputs (the linearization, C, the box) are
//   computed and loaded in rounds of L, one step a lane, into the group's
//   shared memory.
// The serial chains (the initial rollout, a replay, and but for the shared
// sweep at 16 lanes the Riccati sweep) stay one chain: every lane of the
// group runs it on the same values, in lockstep, so no result needs to be
// broadcast and the warp executes each instruction once for all of its
// lanes. The per-scenario bookkeeping is the same scalar arithmetic on
// every lane.
//
// L = 1 is the one-thread program: the same loads from device memory, the
// same operations in the same order, no barrier, the replay. Every L
// computes the same float32 operations on the same values as L = 1, so its
// outputs are bit for bit the same (the shared sweep's sources are built
// without FMA contraction, fused by hand as the Riccati kernel's are).
//
// Layout: every per-step array is batch-minor, (T, entries..., B), so that
// neighbouring scenarios touch neighbouring addresses. The value carry
// (V, v) and the per-step Q, q, W live in registers.
#pragma once

#include "dual.cuh"
#include "lanes.cuh"
#include "riccati.cuh"
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
  // the unrolled ladder's step sizes (n_alpha,), decay**k in double rounded
  // once to float32; null for the rolled ladder (alpha *= decay in float32)
  const float* alphas;
  // each lane's candidate trajectory, (T, N, B, lanes) and (T, M, B,
  // lanes); null with one lane
  float* lane_x;
  float* lane_u;
  int lanes;      // threads per scenario, L
  int pnqp_iter;  // the box QP's projected-Newton steps, where it loops (pnqp_entries)
};

// One step's slice as the ladder and the replay read it: C (all of it: the
// stage cost reads both triangles), c, K, k, x_hat, u_hat, the box.
template <int N, int M>
struct IlqrSlice {
  static constexpr int NM = N + M;
  static constexpr int kc = NM * NM;
  static constexpr int kK = kc + NM;
  static constexpr int kk = kK + M * N;
  static constexpr int kxh = kk + M;
  static constexpr int kuh = kxh + N;
  static constexpr int klo = kuh + M;
  static constexpr int khi = klo + M;
  static constexpr int kSize = khi + M;
};

// Whether a group of L lanes keeps each lane's candidate trajectory, so
// that the chosen one needs no replay. On the H100 (ab_ilqr_lanes, rows
// 1-1b of PERF.md) keeping pays at 16 lanes, where the replay is a third of
// an iteration, and at every L > 1 for an env whose step is dear (the
// MLPs'); a cheap step (the pendulum's) replays faster at 2 and 4 lanes
// than its lanes store it. The wrapper allocates lane_x, lane_u by the same
// rule (keeps_lane_trajectories, from its env's cheap_step), and a launch
// whose scratch disagrees with it is refused (ilqr_lane_scratch_ok).
template <class Env, int L>
constexpr bool ilqr_keeps_lanes() {
  return L >= 16 || (L > 1 && !Env::kCheapStep);
}

// Whether the args carry the lanes' trajectory slots exactly when the
// groups of L lanes keep them.
template <class Env, int L>
DMPC_HD bool ilqr_lane_scratch_ok(const IlqrArgs& a) {
  return (a.lane_x != nullptr) == ilqr_keeps_lanes<Env, L>() && (a.lane_u != nullptr) == ilqr_keeps_lanes<Env, L>();
}

// Floats of staging a group of lanes needs: kLaneStages slots of a slice
template <int N, int M>
constexpr int ilqr_group_slot_floats() {
  return kLaneStages * IlqrSlice<N, M>::kSize;
}

// The lane count from which the shared sweep shares each step's arithmetic
// out over the group (riccati_lanes_step); below it every lane runs the
// one-lane step on the same values. On the H100 two and four lanes shared
// the step out slower than the sweep every lane repeats (the (6, 2) wrap
// at B=1024: 4.25 / 3.01 against 2.83 / 2.17 ms; PERF.md, PR 21).
constexpr int kSweepShareLanes = 16;

// One step's inputs of the shared sweep as a round writes them into the
// group's shared memory (riccati_sweep_shared): the Jacobian F (row-major,
// N x NM), the delta cost cd, C's upper triangle (row by row), and the box
// about u_hat (lo - u_hat, hi - u_hat).
template <int N, int M>
struct LinSlice {
  static constexpr int NM = N + M;
  static constexpr int kcd = N * NM;
  static constexpr int kC = kcd + NM;
  static constexpr int klo = kC + NM * (NM + 1) / 2;
  static constexpr int khi = klo + M;
  static constexpr int kSize = khi + M;
};

// Floats of shared memory a group of L lanes needs: the ladder's staging
// ring, and where the shared sweep shares its steps out, in the same place,
// its round of L steps' inputs and riccati.cuh's exchange scratch,
// whichever is larger.
template <int N, int M, bool Shared, int L, int ENUM = kPnqpEnumDefault>
constexpr int ilqr_group_floats() {
  constexpr int ladder = ilqr_group_slot_floats<N, M>();
  constexpr int sweep = L * LinSlice<N, M>::kSize + RiccatiScratch<N, M, ENUM>::kSize;
  return Shared && L >= kSweepShareLanes && sweep > ladder ? sweep : ladder;
}

// The phases of a solve that the profile build counts (IlqrProfile): the
// initial rollout, the linearization, the sweep's loads (their issue and,
// in the profile build, their arrival), the sweep's arithmetic with the box
// QP and the gains' stores, the ladder, the new trajectory (the kept slot's
// copy or the replay), and the bookkeeping between them.
enum IlqrPhase { kPhaseInit, kPhaseLin, kPhaseLoads, kPhaseSweep, kPhaseLadder, kPhaseKeep, kPhaseBook, kIlqrPhases };

// Built with DMPC_ILQR_PROFILE (a diagnostic build), each group's first
// lane counts the cycles (clock64) of each phase of its scenario and adds
// them to ilqr_profile_cycles when the scenario is done, with one more
// count for the scenario itself (read back by diffmpc_ilqr_profile_l<L>,
// csrc/variants/ilqr.cu). wait(v) makes the next mark wait for v's load to
// arrive. Elsewhere every member does nothing.
#ifdef DMPC_ILQR_PROFILE
static __device__ unsigned long long ilqr_profile_cycles[kIlqrPhases + 1];
#endif
#if defined(DMPC_ILQR_PROFILE) && defined(__CUDA_ARCH__)
struct IlqrProfile {
  unsigned long long c[kIlqrPhases] = {};
  long long last = clock64();
  float keep = 0.0f;
  __device__ void mark(int phase) {
    const long long now = clock64();
    c[phase] += now - last;
    last = now;
  }
  __device__ void wait(float v) { asm volatile("add.f32 %0, %0, %1;" : "+f"(keep) : "f"(v)); }
  __device__ void flush(bool leader) {
    if (!leader) return;
    for (int i = 0; i < kIlqrPhases; ++i) atomicAdd(&ilqr_profile_cycles[i], c[i]);
    atomicAdd(&ilqr_profile_cycles[kIlqrPhases], keep == 1.0e-38f ? 2ull : 1ull);  // the waits' sums stay live
  }
};
#else
struct IlqrProfile {
  DMPC_HD void mark(int) {}
  DMPC_HD void wait(float) {}
  DMPC_HD void flush(bool) {}
};
#endif

namespace ilqr_detail {

// element (t, i) of a batch-minor (T, D, B) array, for scenario b
DMPC_HD size_t at(int t, int i, int D, int B, int b) {
  return ((size_t)t * D + i) * (size_t)B + b;
}

// Step t's inputs for scenario b, read from device memory
template <int N, int M>
struct GlobalStep {
  static constexpr int NM = N + M;
  const IlqrArgs& a;
  int t;
  int b;
  DMPC_HD size_t at(int i, int D) const { return ilqr_detail::at(t, i, D, a.B, b); }
  DMPC_HD float C(int i, int j) const { return a.C[at(i * NM + j, NM * NM)]; }
  DMPC_HD float c(int i) const { return a.c[at(i, NM)]; }
  DMPC_HD float K(int i, int j) const { return a.K[at(i * N + j, M * N)]; }
  DMPC_HD float k(int i) const { return a.k[at(i, M)]; }
  DMPC_HD float xh(int i) const { return a.x_hat[at(i, N)]; }
  DMPC_HD float uh(int i) const { return a.u_hat[at(i, M)]; }
  DMPC_HD float lo(int i) const { return a.u_lower[at(i, M)]; }
  DMPC_HD float hi(int i) const { return a.u_upper[at(i, M)]; }
};

// Step t's inputs from a staging slot
template <int N, int M>
struct SlotStep {
  using S = IlqrSlice<N, M>;
  SlotReader e;
  DMPC_HD float C(int i, int j) const { return e[i * S::NM + j]; }
  DMPC_HD float c(int i) const { return e[S::kc + i]; }
  DMPC_HD float K(int i, int j) const { return e[S::kK + i * N + j]; }
  DMPC_HD float k(int i) const { return e[S::kk + i]; }
  DMPC_HD float xh(int i) const { return e[S::kxh + i]; }
  DMPC_HD float uh(int i) const { return e[S::kuh + i]; }
  DMPC_HD float lo(int i) const { return e[S::klo + i]; }
  DMPC_HD float hi(int i) const { return e[S::khi + i]; }
};

// Start this lane's share of the copies of step t's slice into `slot`.
template <int N, int M, class G>
DMPC_HD void stage_step(const IlqrArgs& a, const G& g, int t, int b, float* slot) {
  using S = IlqrSlice<N, M>;
  constexpr int NM = N + M;
  const int B = a.B;
  for (int i = 0; i < NM * NM; ++i) stage_put(g, slot, i, &a.C[at(t, i, NM * NM, B, b)]);
  for (int i = 0; i < NM; ++i) stage_put(g, slot, S::kc + i, &a.c[at(t, i, NM, B, b)]);
  for (int i = 0; i < M * N; ++i) stage_put(g, slot, S::kK + i, &a.K[at(t, i, M * N, B, b)]);
  for (int i = 0; i < M; ++i) stage_put(g, slot, S::kk + i, &a.k[at(t, i, M, B, b)]);
  for (int i = 0; i < N; ++i) stage_put(g, slot, S::kxh + i, &a.x_hat[at(t, i, N, B, b)]);
  for (int i = 0; i < M; ++i) {
    stage_put(g, slot, S::kuh + i, &a.u_hat[at(t, i, M, B, b)]);
    stage_put(g, slot, S::klo + i, &a.u_lower[at(t, i, M, B, b)]);
    stage_put(g, slot, S::khi + i, &a.u_upper[at(t, i, M, B, b)]);
  }
  stream_commit();
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

// u = u_hat + alpha k + K (x - x_hat), then the delta_u clip, then the box
template <int N, int M, class In>
DMPC_HD void control(const IlqrArgs& a, const In& in, const float (&x)[N], float alpha, float (&u)[M]) {
  for (int i = 0; i < M; ++i) {
    const float uh = in.uh(i);
    float acc = uh + alpha * in.k(i);
    for (int j = 0; j < N; ++j) acc = acc + in.K(i, j) * (x[j] - in.xh(j));
    if (a.has_delta_u) acc = clipf(acc, uh - a.delta_u, uh + a.delta_u);
    u[i] = clipf(acc, in.lo(i), in.hi(i));
  }
}

// Where a rollout writes its trajectory: nowhere, into (x_hat, u_hat) (the
// replay; step t by the lane that owns it), or into the lane's own slot of
// lane_x, lane_u while `keep`
enum RolloutStore { kStoreNone, kStoreHat, kStoreLane };

// Step t of a closed-loop rollout at step size alpha, its inputs read
// through `in`: the control, its store, the stage cost added to obj, the
// env's step.
template <int N, int M, int Store, class In, class Env, class G>
DMPC_HD void rollout_step(const IlqrArgs& a, const In& in, const Env& env, const float* p, int b, const G& g,
                          int t, float alpha, int lane, bool keep, float (&x)[N], float& obj) {
  float u[M], xn[N];
  control<N, M>(a, in, x, alpha, u);
  if constexpr (Store == kStoreHat) {
    if (g.owns(t)) {
      for (int i = 0; i < N; ++i) a.x_hat[at(t, i, N, a.B, b)] = x[i];
      for (int i = 0; i < M; ++i) a.u_hat[at(t, i, M, a.B, b)] = u[i];
    }
  } else if constexpr (Store == kStoreLane) {
    if (keep) {
      for (int i = 0; i < N; ++i) a.lane_x[lane_at(t, i, N, a.B, b, G::kLanes, lane)] = x[i];
      for (int i = 0; i < M; ++i) a.lane_u[lane_at(t, i, M, a.B, b, G::kLanes, lane)] = u[i];
    }
  }
  obj += stage_cost<N, M>(in, x, u);
  env.step(p, x, u, xn);
  for (int i = 0; i < N; ++i) x[i] = xn[i];
}

// The group's staging slot of step t
template <int N, int M, class G>
DMPC_HD float* stage_slot(const G& g, int t) {
  return ::stage_slot(g, t, IlqrSlice<N, M>::kSize, kLaneStages);
}

// The closed-loop rollout at step size alpha from x0, returning its cost and
// writing its trajectory where Store says (lane: the calling lane). Every
// lane of the group calls it together (each at its own alpha); with L > 1
// the group stages the steps' slices.
template <int N, int M, int Store, class Env, class G>
DMPC_HD float rollout(const IlqrArgs& a, const Env& env, const float* p, int b, const G& g,
                      const float (&x0)[N], float alpha, int lane = 0, bool keep = false) {
  const int T = a.T;
  float x[N];
  for (int i = 0; i < N; ++i) x[i] = x0[i];
  float obj = 0.0f;
  if constexpr (G::kLanes == 1) {
    for (int t = 0; t < T; ++t)
      rollout_step<N, M, Store>(a, GlobalStep<N, M>{a, t, b}, env, p, b, g, t, alpha, lane, keep, x, obj);
  } else {
    g.sync();  // every lane is done with the slots' last contents
    for (int s = 0; s < kLaneStages - 1; ++s) {
      if (s < T) stage_step<N, M>(a, g, s, b, stage_slot<N, M>(g, s));
      else stream_commit();
    }
    for (int t = 0; t < T; ++t) {
      stream_wait<kLaneStages - 2>();  // this lane's copies of step t
      g.sync();                        // and every other lane's
      const int ahead = t + kLaneStages - 1;
      if (ahead < T) stage_step<N, M>(a, g, ahead, b, stage_slot<N, M>(g, ahead));
      else stream_commit();
      const SlotStep<N, M> in{SlotReader{stage_slot<N, M>(g, t), g.stride}};
      rollout_step<N, M, Store>(a, in, env, p, b, g, t, alpha, lane, keep, x, obj);
    }
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
// pre-pass first writes every step's Ft, cd to F_s, cd_s: lane j the steps
// t = j, j + L, .... Every lane runs the sweep itself, on the same values.
// ENUM is the box QP's enumeration mode (pnqp_entries); EXACT takes the
// simplified value update (value_update), which the wrapper asks for only
// where that QP is exact (ops/cuda/riccati.py, use_exact_value_update).
template <int N, int M, bool HoistLin, int ENUM, bool EXACT, class Env, class G>
DMPC_HD float riccati_sweep(const IlqrArgs& a, const Env& env, const float* p, int b, const G& g, IlqrProfile& prof) {
  constexpr int NM = N + M;
  const int B = a.B;
  if constexpr (HoistLin) {
    for (int li = 0; li < G::kLocal; ++li) {
      for (int t = g.lane_of(li); t < a.T; t += G::kLanes) {  // independent iterations
        float Ft[N][NM], cd[NM];
        linearize_at<N, M>(a, env, p, b, t, Ft, cd);
        for (int k = 0; k < N; ++k)
          for (int j = 0; j < NM; ++j) a.F_s[at(t, k * NM + j, N * NM, B, b)] = Ft[k][j];
        for (int i = 0; i < NM; ++i) a.cd_s[at(t, i, NM, B, b)] = cd[i];
      }
    }
    g.publish();
    prof.mark(kPhaseLin);
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
      prof.wait(cd[NM - 1]);
      prof.mark(kPhaseLin);
    }
    for (int i = 0; i < M; ++i) uh[i] = a.u_hat[at(t, i, M, B, b)];
    for (int i = 0; i < NM; ++i)
      for (int j = 0; j < NM; ++j) Ct[i][j] = a.C[at(t, i * NM + j, NM * NM, B, b)];
    for (int i = 0; i < M; ++i) prof.wait(uh[i]);
    for (int i = 0; i < NM; ++i) prof.wait(Ct[i][NM - 1]);
    if constexpr (HoistLin) prof.wait(Ft[N - 1][NM - 1]), prof.wait(cd[NM - 1]);
    prof.mark(kPhaseLoads);
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
    // the fused path caps pnqp_iter at 8 (mpc.py); only the loop reads it
    qp_sum += pnqp_entries<M, false, ENUM>(Quu, qu, lo_d, hi_d, a.pnqp_iter, a.reg, kt, frozen);
    masked_chol_solve<M, N>(Quu, rhs, frozen, a.reg, Kc);
    const bool mine = g.owns(t);
    for (int i = 0; i < M; ++i) {
      for (int j = 0; j < N; ++j) {
        K[i][j] = -Kc[j][i];
        if (mine) a.K[at(t, i * N + j, M * N, B, b)] = K[i][j];
      }
      if (mine) a.k[at(t, i, M, B, b)] = kt[i];
    }
    value_update<N, M, EXACT>(Q, q, Quu, qu, K, kt, V, v);
    prof.mark(kPhaseSweep);
  }
  return qp_sum;
}

// Step t's inputs of the shared sweep from the round's slot (LinSlice):
// riccati.cuh's accessor of box mode without f, cd as the linear cost c.
template <int N, int M>
struct SweepStep {
  using S = LinSlice<N, M>;
  SlotReader e;
  DMPC_HD float C(int i, int j) const { return e[S::kC + upper_index(N + M, i, j)]; }
  DMPC_HD float c(int i) const { return e[S::kcd + i]; }
  DMPC_HD float F(int i, int j) const { return e[i * (N + M) + j]; }
  DMPC_HD bool has_f() const { return false; }
  DMPC_HD float f(int) const { return 0.0f; }
  DMPC_HD float lo(int i) const { return e[S::klo + i]; }
  DMPC_HD float hi(int i) const { return e[S::khi + i]; }
};

// The same inputs in registers: C's upper triangle and the box about u_hat
// read from device memory at once (as riccati.cuh's RiccatiRegs), F and cd
// the step's linearization.
template <int N, int M>
struct SweepRegs {
  static constexpr int NM = N + M;
  float Cu[NM * (NM + 1) / 2], lo_d[M], hi_d[M];
  const float (&Ft)[N][NM];
  const float (&cd)[NM];
  DMPC_HD float C(int i, int j) const { return Cu[upper_index(NM, i, j)]; }
  DMPC_HD float c(int i) const { return cd[i]; }
  DMPC_HD float F(int i, int j) const { return Ft[i][j]; }
  DMPC_HD bool has_f() const { return false; }
  DMPC_HD float f(int) const { return 0.0f; }
  DMPC_HD float lo(int i) const { return lo_d[i]; }
  DMPC_HD float hi(int i) const { return hi_d[i]; }
};

// Step t's C upper triangle and the box about u_hat (lo - u_hat, hi - u_hat,
// as riccati_sweep subtracts them), read from device memory, into `in`.
template <int N, int M>
DMPC_HD void load_step(const IlqrArgs& a, int t, int b, SweepRegs<N, M>& in) {
  constexpr int NM = N + M;
  const int B = a.B;
  for (int i = 0; i < NM; ++i)
    for (int j = i; j < NM; ++j) in.Cu[upper_index(NM, i, j)] = a.C[at(t, i * NM + j, NM * NM, B, b)];
  for (int i = 0; i < M; ++i) {
    const float uh = a.u_hat[at(t, i, M, B, b)];
    in.lo_d[i] = a.u_lower[at(t, i, M, B, b)] - uh;
    in.hi_d[i] = a.u_upper[at(t, i, M, B, b)] - uh;
  }
}

// Where the shared sweep's step puts the gains (riccati_lanes_step's sink):
// K and k; the free mask and the QP count go nowhere.
struct SweepOut {
  const IlqrArgs& a;
  int b;
  DMPC_HD void K(int t, int i, int j, int M, int N, float val) const {
    a.K[at(t, i * N + j, M * N, a.B, b)] = val;
  }
  DMPC_HD void k(int t, int i, int M, float val) const { a.k[at(t, i, M, a.B, b)] = val; }
  DMPC_HD void free(int, int, int, float) const {}
  DMPC_HD void n_qp(int, float) const {}
};

// The delta-form Riccati sweep of riccati_sweep, each step the Riccati
// kernel's own box step (riccati.cuh) on the step's linearization, its sums
// of products fused by hand. Below kSweepShareLanes every lane runs the
// one-lane step, riccati_step, on the same values (with HoistLin after the
// pre-pass, lane j linearizing t = j, j + L, ...); a group of
// kSweepShareLanes shares each step out by riccati_lanes_step (Q's upper
// triangle and q, the m >= 2 enumeration's candidates, the gains' columns,
// V' and v'), the steps' inputs written in rounds of L steps into the
// group's shared memory (LinSlice), lane j linearizing and loading the step
// t - j of a round that starts at t (the HoistLin pre-pass's work, off the
// value carry's chain, at either HoistLin: its device scratch is left
// alone). Every L computes riccati_step's float32 operations on the same
// values, so it gives bit for bit the gains of L = 1. Writes K, k and
// returns the summed box-QP solve count.
template <int N, int M, bool HoistLin, int ENUM, bool EXACT, class Env, class G>
DMPC_HD float riccati_sweep_shared(const IlqrArgs& a, const Env& env, const float* p, int b, const G& g,
                                   IlqrProfile& prof) {
  constexpr int NM = N + M, L = G::kLanes;
  const int T = a.T, B = a.B;
  float V[N][N], v[N];
  for (int i = 0; i < N; ++i) {
    v[i] = 0.0f;
    for (int j = 0; j < N; ++j) V[i][j] = 0.0f;
  }
  float qp_sum = 0.0f;
  if constexpr (L < kSweepShareLanes) {
    if constexpr (HoistLin) {
      for (int li = 0; li < G::kLocal; ++li) {
        for (int t = g.lane_of(li); t < T; t += L) {  // independent iterations
          float Ft[N][NM], cd[NM];
          linearize_at<N, M>(a, env, p, b, t, Ft, cd);
          for (int k = 0; k < N; ++k)
            for (int j = 0; j < NM; ++j) a.F_s[at(t, k * NM + j, N * NM, B, b)] = Ft[k][j];
          for (int i = 0; i < NM; ++i) a.cd_s[at(t, i, NM, B, b)] = cd[i];
        }
      }
      g.publish();
      prof.mark(kPhaseLin);
    }
    for (int s = 0; s < T; ++s) {
      const int t = T - 1 - s;
      float Ft[N][NM], cd[NM];
      if constexpr (HoistLin) {
        for (int k = 0; k < N; ++k)
          for (int j = 0; j < NM; ++j) Ft[k][j] = a.F_s[at(t, k * NM + j, N * NM, B, b)];
        for (int i = 0; i < NM; ++i) cd[i] = a.cd_s[at(t, i, NM, B, b)];
      } else {
        linearize_at<N, M>(a, env, p, b, t, Ft, cd);
        prof.wait(cd[NM - 1]);
        prof.mark(kPhaseLin);
      }
      SweepRegs<N, M> in{{}, {}, {}, Ft, cd};
      load_step<N, M>(a, t, b, in);
      for (int i = 0; i < M; ++i) prof.wait(in.lo_d[i]), prof.wait(in.hi_d[i]);
      prof.wait(in.Cu[NM * (NM + 1) / 2 - 1]);
      if constexpr (HoistLin) prof.wait(Ft[N - 1][NM - 1]), prof.wait(cd[NM - 1]);
      prof.mark(kPhaseLoads);
      float K[M][N], kt[M], frozen[M];
      qp_sum += riccati_step<N, M, kRiccatiBox, ENUM>(in, a.pnqp_iter, a.reg, V, v, K, kt, frozen, EXACT);
      if (g.owns(t)) {
        for (int i = 0; i < M; ++i) {
          for (int j = 0; j < N; ++j) a.K[at(t, i * N + j, M * N, B, b)] = K[i][j];
          a.k[at(t, i, M, B, b)] = kt[i];
        }
      }
      prof.mark(kPhaseSweep);
    }
  } else {
    using Ln = LinSlice<N, M>;
    using Plan = RiccatiLanePlan<N, M, kRiccatiBox, L>;
    const GroupScratch x{g.slots + (size_t)L * Ln::kSize * g.stride, g.stride};
    Plan plan[G::kLocal];
    for (int li = 0; li < G::kLocal; ++li) plan[li].init(g.lane_of(li), false);
    g.sync();  // every lane is done with the ladder's ring, which the rounds take
    for (int s = 0; s < T; ++s) {
      const int t = T - 1 - s;
      float* const slot = g.slots + (size_t)(s % L) * Ln::kSize * g.stride;
      if (s % L == 0) {
        // a round: lane j writes step t - j's inputs (every lane is done
        // with the last round's, read before the barriers of its last step)
        for (int li = 0; li < G::kLocal; ++li) {
          const int j = g.lane_of(li);
          if (t - j < 0) continue;
          float Ft[N][NM], cd[NM];
          linearize_at<N, M>(a, env, p, b, t - j, Ft, cd);
          SweepRegs<N, M> in{{}, {}, {}, Ft, cd};
          load_step<N, M>(a, t - j, b, in);
          const auto put = [&](int e, float val) { slot[((size_t)j * Ln::kSize + e) * g.stride] = val; };
          for (int k = 0; k < N; ++k)
            for (int c = 0; c < NM; ++c) put(k * NM + c, Ft[k][c]);
          for (int i = 0; i < NM; ++i) put(Ln::kcd + i, cd[i]);
          for (int e = 0; e < NM * (NM + 1) / 2; ++e) put(Ln::kC + e, in.Cu[e]);
          for (int i = 0; i < M; ++i) {
            put(Ln::klo + i, in.lo_d[i]);
            put(Ln::khi + i, in.hi_d[i]);
          }
        }
        g.sync();
        prof.mark(kPhaseLin);
      }
      qp_sum += riccati_lanes_step<N, M, kRiccatiBox, ENUM>(g, plan, x, SweepStep<N, M>{SlotReader{slot, g.stride}},
                                                            t, a.reg, a.pnqp_iter, EXACT, SweepOut{a, b}, V, v);
      prof.mark(kPhaseSweep);
    }
  }
  return qp_sum;
}

}  // namespace ilqr_detail

// Solve scenario b with the group of lanes g (HostLanes or CardLanes), its
// env's parameters read from `params` (a.params, or a block's copy of them
// in shared memory). Early exit is per scenario: the TPU kernel skips an
// iteration only once the whole tile is frozen (pl.when at ilqr.py:431),
// but every update of a frozen scenario there is where(active > 0, new,
// old) (:381-410), which leaves it unchanged, and its K, k are never read
// again. So a group that stops at its own convergence computes exactly the
// same result. ENUM and EXACT are riccati_sweep's.
template <int N, int M, bool HoistLin, int ENUM = kPnqpEnumDefault, bool EXACT = false, bool Shared = false, class Env,
          class G>
DMPC_HD void ilqr_solve_scenario(const IlqrArgs& a, const Env& env, int b, const float* params, const G& g) {
  using namespace ilqr_detail;
  constexpr int L = G::kLanes, kLocal = G::kLocal;
  const int T = a.T, B = a.B;
  const float* p = params + (size_t)b * a.params_stride;
  IlqrProfile prof;
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
    if (g.owns(t)) {
      for (int i = 0; i < N; ++i) a.x_hat[at(t, i, N, B, b)] = a.xs[at(t, i, N, B, b)] = x[i];
      for (int i = 0; i < M; ++i) a.u_hat[at(t, i, M, B, b)] = a.us[at(t, i, M, B, b)] = u[i];
    }
    obj += ilqr_detail::stage_cost<N, M>(GlobalStep<N, M>{a, t, b}, x, u);  // rollout.cuh has another
    env.step(p, x, u, xn);
    for (int i = 0; i < N; ++i) x[i] = xn[i];
  }
  g.publish();
  prof.mark(kPhaseInit);
  float cur_obj = obj, best_obj = obj;
  float n_not_improved = 0.0f, last_improvement = INFINITY, last_alpha = 1.0f;
  float n_iters = 0.0f, qp_iters = 0.0f;
  bool done = false;

  for (int it = 0; it < a.lqr_iter && !done; ++it) {
    if constexpr (Shared)
      qp_iters = riccati_sweep_shared<N, M, HoistLin, ENUM, EXACT>(a, env, p, b, g, prof) / (float)T;
    else
      qp_iters = riccati_sweep<N, M, HoistLin, ENUM, EXACT>(a, env, p, b, g, prof) / (float)T;
    g.publish();
    prof.mark(kPhaseBook);

    // the alpha ladder, L candidates a round: the first improving step,
    // else alpha_floor. The rolled ladder's alphas: lane j starts at
    // decay^j, then steps by decay^L, one float32 product at a time.
    float al[kLocal];
    for (int li = 0; li < kLocal; ++li) {
      al[li] = 1.0f;
      for (int j = 0; j < g.lane_of(li); ++j) al[li] = al[li] * a.decay;
    }
    // Where it pays, each lane keeps its candidate's trajectory until one is chosen.
    constexpr bool kKeep = ilqr_keeps_lanes<Env, L>();
    constexpr int kLadderStore = kKeep ? kStoreLane : kStoreNone;
    float chosen = a.alpha_floor, chosen_obj = 0.0f;
    int chosen_lane = -1;
    bool has = false;
    for (int k0 = 0; k0 < a.n_alpha; k0 += L) {
      bool improving[kLocal];
      float step[kLocal], obj_a[kLocal];
      for (int li = 0; li < kLocal; ++li) {
        const int k = k0 + g.lane_of(li);
        step[li] = a.alphas ? a.alphas[k < a.n_alpha ? k : a.n_alpha - 1] : al[li];
        obj_a[li] = rollout<N, M, kLadderStore>(a, env, p, b, g, x0, step[li], g.lane_of(li), !has);
        improving[li] = k < a.n_alpha && obj_a[li] < cur_obj;
        for (int j = 0; j < L; ++j) al[li] = al[li] * a.decay;
      }
      const int first = g.first_set(improving);
      if (first >= 0 && !has) {
        chosen = g.from_lane(step, first);
        chosen_obj = g.from_lane(obj_a, first);
        chosen_lane = first;
        has = true;
      }
    }
    prof.mark(kPhaseLadder);

    // the new trajectory: the chosen lane's slot (its cost is the chosen
    // candidate's), or the replay of the chosen step
    float new_obj;
    if (kKeep && has) {
      g.publish();  // every lane's slot
      for (int li = 0; li < kLocal; ++li) {
        for (int t = g.lane_of(li); t < T; t += L) {
          for (int i = 0; i < N; ++i) a.x_hat[at(t, i, N, B, b)] = a.lane_x[lane_at(t, i, N, B, b, L, chosen_lane)];
          for (int i = 0; i < M; ++i) a.u_hat[at(t, i, M, B, b)] = a.lane_u[lane_at(t, i, M, B, b, L, chosen_lane)];
        }
      }
      new_obj = chosen_obj;
    } else if constexpr (L == 1) {
      // rollout<kStoreHat>'s steps, written out: so the one-lane build runs
      // 4-21% faster on a full card (B = 65,536), where the rule takes one
      // lane, and slower on a nearly idle one, where it takes 16 (PERF.md)
      float x[N], u[M], xn[N];
      for (int i = 0; i < N; ++i) x[i] = x0[i];
      new_obj = 0.0f;
      for (int t = 0; t < T; ++t) {
        const GlobalStep<N, M> in{a, t, b};
        control<N, M>(a, in, x, chosen, u);
        for (int i = 0; i < N; ++i) a.x_hat[at(t, i, N, B, b)] = x[i];
        for (int i = 0; i < M; ++i) a.u_hat[at(t, i, M, B, b)] = u[i];
        new_obj += stage_cost<N, M>(in, x, u);
        env.step(p, x, u, xn);
        for (int i = 0; i < N; ++i) x[i] = xn[i];
      }
    } else {
      new_obj = rollout<N, M, kStoreHat>(a, env, p, b, g, x0, chosen);
    }
    g.publish();
    prof.mark(kPhaseKeep);
    cur_obj = new_obj;

    const bool improved = new_obj < best_obj;
    const bool improved_sig = new_obj < best_obj - a.best_cost_eps;
    const float improvement = best_obj - new_obj;
    if (improved) {
      for (int li = 0; li < kLocal; ++li) {
        for (int t = g.lane_of(li); t < T; t += L) {
          for (int i = 0; i < N; ++i) a.xs[at(t, i, N, B, b)] = a.x_hat[at(t, i, N, B, b)];
          for (int i = 0; i < M; ++i) a.us[at(t, i, M, B, b)] = a.u_hat[at(t, i, M, B, b)];
        }
      }
      best_obj = new_obj;
    }
    n_not_improved = improved_sig ? 0.0f : n_not_improved + 1.0f;
    last_improvement = improvement;
    last_alpha = chosen;
    n_iters += 1.0f;
    done = (improvement < a.eps) || (n_not_improved >= (float)a.not_improved_lim);
    prof.mark(kPhaseBook);
  }

  if (g.leader()) {
    a.objs[b] = best_obj;
    a.converged[b] = last_improvement < a.eps ? 1.0f : 0.0f;
    a.last_improvement[b] = last_improvement;
    a.alpha[b] = last_alpha;
    a.n_iters[b] = n_iters;
    a.qp_iters[b] = qp_iters;
  }
  prof.mark(kPhaseBook);
  prof.flush(g.leader());
}

template <int N, int M, bool HoistLin, int ENUM = kPnqpEnumDefault, bool EXACT = false, bool Shared = false, class Env,
          class G>
DMPC_HD void ilqr_solve_scenario(const IlqrArgs& a, const Env& env, int b, const G& g) {
  ilqr_solve_scenario<N, M, HoistLin, ENUM, EXACT, Shared>(a, env, b, a.params, g);
}
