// The alpha-ladder line-search rollout of ONE scenario, by a group of L lanes.
//
// Counterpart of the TPU kernel bodies _make_kernel in
// diffmpc_tpu/ops/pallas/rollout.py (:45-177) and
// diffmpc_tpu/ops/pallas/rollout_stream.py (:35-193), computing what they
// compute, with a group of L threads (lanes.cuh: "lanes", L in 1, 2, 4, 16)
// in place of one lane of an (S, 128) tile. csrc/rollout.cu (the resident
// kernel) and csrc/rollout_stream.cu (its streaming twin) run it on the card
// (rollout_launch.cuh); the tests build it with g++ for the host, where the
// lanes of a group run one after another (HostLanes).
// diffmpc_tpu_torch/ops/cuda/rollout.py (linesearch_rollout_plain) is the
// same algorithm in plain PyTorch, vectorised over the batch.
//
// The accept baseline obj0 is the cost of the current trajectory
// (x_hat, u_hat); the ladder's candidate k runs the closed-loop rollout
//   u_t = clip(clip(u_hat + alpha_k k + K (x - x_hat), u_hat +- delta_u), box)
// through the dynamics (linear, x' = F_t tau + f_t, LinearEnv; or an env's
// own step, PendulumEnv, NNEnv), and the pick is the first strictly
// improving candidate, else alpha_floor = decay^(n_alpha - 1). The rolled
// ladder's alpha_k is 1 * decay * ... carried k times in float32, the
// serial loop's value; with `alphas` (unroll) it is the wrapper's decay**k,
// rounded once.
//
// What the lanes share out:
// - the ladder: lane j rolls out candidates j, j + L, ..., kPer of them side
//   by side in each pass over the horizon (rollout_pass_states: enough for
//   the whole ladder in one pass, or one a lane for an MLP's step), all lanes
//   advancing step t together; the baseline's stage costs ride the first
//   pass, at 16 lanes row i of each step's C tau by lane i % L and the rows'
//   terms added up by every lane in the one-thread order
//   (baseline_stage_cost), below it by every lane on the same values. The pick
//   is a ballot over the group, state by state, pass by pass: the lowest
//   improving candidate by ladder index. A group stops after the first pass
//   that holds an improving candidate: the later candidates cannot change
//   the pick (the TPU kernels compute them only to mask them). The lane just
//   past the ladder in the last pass (lane n_alpha - k0, where the group has
//   one: at 16 lanes, any ladder shorter than 16) rolls out alpha_floor, the
//   pick where none improves;
// - each step's slice (C, c, K, k, x_hat, u_hat, the box, and F, f for
//   linear dynamics), where Staged (the twin; the resident kernel too but
//   for an MLP's step): copied once for the group into shared memory,
//   entries split over the lanes, rollout_stages - 1 steps ahead, and read
//   back as a broadcast. Without it each lane loads the slice from device memory
//   itself;
// - the trajectory (rollout_keeps_lanes): each lane keeps the trajectory of
//   its first candidate of the pass (one lane's in xs, us directly), and
//   where the chosen candidate is one of those, the chosen lane's slot
//   becomes xs, us, its cost objs; where none improves, so does the slot of
//   a lane whose first candidate of the last pass stepped by alpha_floor's
//   very bits (the lane past the ladder, or the ladder's last step where it
//   lands on them: the unrolled ladder's, or a rolled one's product chain
//   that does). Otherwise the chosen step is replayed: every lane runs the
//   same chain in lockstep, step t stored by lane t % L.
//
// Every candidate runs the float32 operations of the one-thread program in
// the same order on the same values, so every L gives bit for bit the same
// outputs as L = 1.
//
// Layout: every per-step array is batch-minor, (T, entries..., B).
#pragma once

#include <cstring>

#include "dual.cuh"
#include "lanes.cuh"

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
  // the unrolled ladder's step sizes (n_alpha,), decay**k in double rounded
  // once to float32; null for the rolled ladder (alpha *= decay in float32)
  const float* alphas;
  // each lane's candidate trajectory, (T, N, B, lanes) and (T, M, B,
  // lanes), where rollout_keeps_lanes; null otherwise
  float* lane_x;
  float* lane_u;
  int lanes;  // threads per scenario, L
};

// Linear dynamics x_{t+1} = F_t [x; u] + f_t from the args' F, f.
struct LinearEnv {
  // a few dozen operations a step (rollout_pass_states)
  static constexpr bool kCheapStep = true;
};

template <class Env>
struct IsLinearEnv {
  static constexpr bool value = false;
};
template <>
struct IsLinearEnv<LinearEnv> {
  static constexpr bool value = true;
};

// The default ladder length (max_linesearch_iter)
constexpr int kLadder = 10;

// Candidates a lane carries side by side through one pass over the horizon.
// An env with a cheap step (linear dynamics, the pendulum) carries enough
// that L lanes cover the default ladder in one pass, ceil(10 / L): a
// scenario whose full step does not improve (on config 2's solves, 55-70%
// of them) then reads the horizon twice at most, where rounds of L read it
// up to ceil(10 / L) + 1 times (ab_rollout_lanes on an NVIDIA H100 80GB
// HBM3 at 700 W: 3.86 against 14.5 ms for a T=20 solve's calls at
// B=65,536). An env with a dear step (an MLP) carries one, a round of L
// candidates a pass: ceil(10 / L) MLP states in one thread's registers lose
// (28.6 against 54.1 ms at T=128, B=65,536, L=4). Built with DMPC_ROLLOUT_FLIP_PASSES (the A/B's other build), each
// env takes the other choice.
#ifndef DMPC_ROLLOUT_FLIP_PASSES
#define DMPC_ROLLOUT_FLIP_PASSES 0
#endif
template <class Env, int L>
DMPC_HD constexpr int rollout_pass_states() {
  return Env::kCheapStep != (DMPC_ROLLOUT_FLIP_PASSES != 0) ? (kLadder + L - 1) / L : 1;
}

// Whether a group of L lanes keeps the trajectory of each lane's first
// candidate of a pass in its own slot of lane_x, lane_u, so that picking one
// of them needs no replay: every group of more than one lane. With one lane
// the slot is xs, us themselves. The wrapper allocates lane_x, lane_u by the
// same rule (rollout_keeps_lane_trajectories), and a launch whose scratch
// disagrees with it is refused (rollout_lane_scratch_ok).
template <int L>
DMPC_HD constexpr bool rollout_keeps_lanes() {
  return L > 1;
}

// Whether the args carry the lanes' trajectory slots exactly when the
// groups of L lanes keep them.
template <int L>
DMPC_HD bool rollout_lane_scratch_ok(const RolloutArgs& a) {
  return (a.lane_x != nullptr) == rollout_keeps_lanes<L>() && (a.lane_u != nullptr) == rollout_keeps_lanes<L>();
}

// The phases of a line search that the profile build counts
// (RolloutProfile): the start (x_init, the alphas), the staged slices'
// copies issued, the wait for them and the group's barrier, each
// candidate's control, stage cost and env step, the baseline's stage cost,
// the pick, the kept slot's copy and the replay (all of its pass).
enum RolloutPhase {
  kRolloutInit,
  kRolloutLoads,
  kRolloutWait,
  kRolloutControl,
  kRolloutCost,
  kRolloutBase,
  kRolloutStep,
  kRolloutPick,
  kRolloutKeep,
  kRolloutReplay,
  kRolloutPhases
};

// Built with DMPC_ROLLOUT_PROFILE (a diagnostic build), each lane counts the
// cycles (clock64) of each phase of its scenario and the group's first lane
// adds them to rollout_profile_cycles when the scenario is done, with one
// more count for the scenario itself (read back by
// diffmpc_rollout_profile_l<L>, csrc/variants/rollout.cu). Inside the
// replay every mark counts to kRolloutReplay. Elsewhere every member does
// nothing.
#ifdef DMPC_ROLLOUT_PROFILE
static __device__ unsigned long long rollout_profile_cycles[kRolloutPhases + 1];
#endif
#if defined(DMPC_ROLLOUT_PROFILE) && defined(__CUDA_ARCH__)
struct RolloutProfile {
  unsigned long long c[kRolloutPhases] = {};
  long long last = clock64();
  bool replay = false;
  __device__ void mark(int phase) {
    const long long now = clock64();
    if (replay)
      c[kRolloutReplay] += now - last;
    else
      c[phase] += now - last;
    last = now;
  }
  __device__ void flush(bool leader) {
    if (!leader) return;
    for (int i = 0; i < kRolloutPhases; ++i) atomicAdd(&rollout_profile_cycles[i], c[i]);
    atomicAdd(&rollout_profile_cycles[kRolloutPhases], 1ull);
  }
};
#else
struct RolloutProfile {
  bool replay = false;
  DMPC_HD void mark(int) {}
  DMPC_HD void flush(bool) {}
};
#endif

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

// One step's staged slice: C (all of it: the stage cost reads both
// triangles), c, K, k, x_hat, u_hat, the box, then F and f for linear
// dynamics. The box and f are copied only when the args have them.
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

// Step inputs from a staging slot: the accessor of rollout_control,
// stage_cost and advance.
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

// Slots of a group's staging ring: the group computes step t while the
// copies of the next rollout_stages - 2 steps are in flight. A cheap step
// of one to three candidates a lane is a few hundred cycles, too few to
// cover the latency of device memory, so for a cheap step the ring deepens
// with the lanes, 2 L slots, at least 3 and at most 16: a block of 64
// threads holds 192 slices at one lane (69 KB for n = 4, m = 2, linear),
// 128 at two and four lanes and 64 at sixteen, and a group of 4 or 16 lanes
// keeps 7 or 15 steps of copies in flight (ab_rollout_lanes on an NVIDIA
// H100 80GB HBM3 at 700 W, against a ring of 3: config 2's T=20 calls at
// B=128 0.409 against 0.482 ms, 4 lanes; at T=128 5.07 against 6.17; the
// pendulum at T=256, B=1024, 3.67 against 4.49, 16 lanes). An MLP's step
// hides it itself, and keeps 3 (its twin lost 5% with the deeper ring).
// Built with DMPC_ROLLOUT_STAGES (the A/B's other build), a ring of that
// many for every env and L.
template <class Env, int L>
DMPC_HD constexpr int rollout_stages() {
#ifdef DMPC_ROLLOUT_STAGES
  return DMPC_ROLLOUT_STAGES;
#else
  return !Env::kCheapStep || 2 * L < 3 ? 3 : (2 * L > 16 ? 16 : 2 * L);
#endif
}

// Floats of staging a group of L lanes needs: its ring of slices
template <int N, int M, class Env, int L>
constexpr int rollout_group_slot_floats() {
  return rollout_stages<Env, L>() * RolloutSlice<N, M, Env>::kSize;
}

// Start this lane's copies of the D entries of one array at slot entries
// Off .. Off + D - 1: entry i of step t, base[(t D + i) B + b], lands at
// slot entry Off + i and falls to lane (Off + i) % L. Each lane walks its
// own entries only, L apart, one pointer step each, so that a lane of a
// group of L issues about 1/L of the slice's copies and does 1/L of the
// work (a loop over every entry, each lane testing whether it is its own,
// cost a lane of 16 as much as the whole slice: .23-.65 of the variants'
// cycles at 16 lanes, diagnostics/ab_rollout_lanes.py --variants
// --profile on an NVIDIA H100 80GB HBM3 at 700 W).
template <int D, int Off, class G>
DMPC_HD void stage_array(const G& g, float* slot, const float* base, int t, int B, int b) {
  constexpr int L = G::kLanes, kMost = (D + L - 1) / L;
  static_assert((L & (L - 1)) == 0, "a group's lane count is a power of two");
  for (int li = 0; li < G::kLocal; ++li) {
    const int i0 = (g.lane_of(li) - Off) & (L - 1);  // this lane's first entry
    const float* src = base + ((size_t)t * D + i0) * B + b;
#pragma unroll
    for (int j = 0; j < kMost; ++j) {
      if (i0 + j * L < D) stream_put(slot, g.stride, Off + i0 + j * L, src);
      src += (size_t)L * B;
    }
  }
}

// Start this lane's share of the copies of step t's slice into `slot`
// (entry e by lane e % L).
template <int N, int M, class Env, class G>
DMPC_HD void rollout_stage(const RolloutArgs& a, const G& g, int t, int b, float* slot) {
  using S = RolloutSlice<N, M, Env>;
  constexpr int NM = N + M;
  const int B = a.B;
  stage_array<NM * NM, 0>(g, slot, a.C, t, B, b);
  stage_array<NM, S::kc>(g, slot, a.c, t, B, b);
  stage_array<M * N, S::kK>(g, slot, a.K, t, B, b);
  stage_array<M, S::kk>(g, slot, a.k, t, B, b);
  stage_array<N, S::kxh>(g, slot, a.x_hat, t, B, b);
  stage_array<M, S::kuh>(g, slot, a.u_hat, t, B, b);
  if (a.u_lower) {
    stage_array<M, S::klo>(g, slot, a.u_lower, t, B, b);
    stage_array<M, S::khi>(g, slot, a.u_upper, t, B, b);
  }
  if constexpr (IsLinearEnv<Env>::value) {
    stage_array<N * NM, S::kF>(g, slot, a.F, t, B, b);
    if (a.f) stage_array<N, S::kf>(g, slot, a.f, t, B, b);
  }
  stream_commit();
}

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

// Row i of C_t tau
template <int NM, class In>
DMPC_HD float stage_cost_row(const In& in, const float (&tau)[NM], int i) {
  float Ctau = 0.0f;
  for (int j = 0; j < NM; ++j) Ctau += in.C(i, j) * tau[j];
  return Ctau;
}

// acc plus row i's term of the stage cost, from the row's C_t tau
DMPC_HD float stage_cost_term(float acc, float Ctau, float c, float tau) {
  return acc + (0.5f * Ctau + c) * tau;
}

// 0.5 tau'C_t tau + c_t'tau, summed in the TPU kernel's order (stage_cost)
template <int N, int M, class In>
DMPC_HD float stage_cost(const In& in, const float (&x)[N], const float (&u)[M]) {
  constexpr int NM = N + M;
  float tau[NM];
  for (int i = 0; i < N; ++i) tau[i] = x[i];
  for (int i = 0; i < M; ++i) tau[N + i] = u[i];
  float acc = 0.0f;
  for (int i = 0; i < NM; ++i) acc = stage_cost_term(acc, stage_cost_row(in, tau, i), in.c(i), tau[i]);
  return acc;
}

// The least lane count whose groups share the baseline's stage cost out
// (baseline_stage_cost); fewer lanes each add it up themselves. At 16 lanes
// (one candidate a lane) the cartpole's baseline took 0.85 of the cycles a
// scenario that every lane's own sum took (ab_rollout_lanes --variants
// --profile on an NVIDIA H100 80GB HBM3 at 700 W). A build that shared it
// at every lane count ran 3-11% slower than the one before at 2 and 4 lanes
// on a cheap env's long horizons (the pendulum at T=256, the cartpole and
// the pendulum's wrap at T=128), where every lane summed it; those counts
// keep the sum.
constexpr int kRolloutShareBaselineLanes = 16;

// stage_cost of (x_hat_t, u_hat_t), the baseline's, by the group g: row i's
// C_t tau by lane i % L, then every lane adds the rows' terms up in
// stage_cost's order, each row's from the lane that computed it.
template <int N, int M, class In, class G>
DMPC_HD float baseline_stage_cost(const In& in, const G& g) {
  constexpr int NM = N + M, L = G::kLanes, kRows = (NM + L - 1) / L;
  float tau[NM];
  for (int i = 0; i < N; ++i) tau[i] = in.xh(i);
  for (int i = 0; i < M; ++i) tau[N + i] = in.uh(i);
  float rows[G::kLocal][kRows];
  for (int li = 0; li < G::kLocal; ++li)
    for (int r = 0; r < kRows; ++r) {
      const int i = g.lane_of(li) + r * L;
      rows[li][r] = i < NM ? stage_cost_row(in, tau, i) : 0.0f;
    }
  float acc = 0.0f;
  for (int i = 0; i < NM; ++i) {
    float v[G::kLocal];
    for (int li = 0; li < G::kLocal; ++li) v[li] = rows[li][i / L];
    acc = stage_cost_term(acc, g.from_lane(v, i % L), in.c(i), tau[i]);
  }
  return acc;
}

// Whether two floats have the same bits
DMPC_HD bool same_bits(float a, float b) {
  unsigned ua, ub;
  memcpy(&ua, &a, sizeof(ua));
  memcpy(&ub, &b, sizeof(ub));
  return ua == ub;
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

// One step of one closed-loop rollout at step size alpha: the control, its
// store at (xs, us) + (t, b)'s offsets when `xs` is set (entries `ld` apart
// along i), the stage cost added to obj, the env's step.
template <int N, int M, class In, class Env>
DMPC_HD void rollout_step(const RolloutArgs& a, const In& in, const Env& env, const float* p, float alpha,
                          float* xs, float* us, size_t ld, float (&x)[N], float& obj, RolloutProfile& prof) {
  float u[M], xn[N];
  rollout_control<N, M>(a, in, x, alpha, u);
  prof.mark(kRolloutControl);
  if (xs) {
    for (int i = 0; i < N; ++i) xs[i * ld] = x[i];
    for (int i = 0; i < M; ++i) us[i * ld] = u[i];
  }
  obj = obj + stage_cost<N, M>(in, x, u);
  prof.mark(kRolloutCost);
  advance<N, M>(in, env, p, x, u, xn);
  for (int i = 0; i < N; ++i) x[i] = xn[i];
  prof.mark(kRolloutStep);
}

// One pass over the horizon: body(in, t) for every step t with its inputs
// `in`, read from device memory, or (Staged) from the group's staging ring,
// each step's slice copied once for the group, rollout_stages - 1 steps
// ahead. Every lane of the group calls it together.
template <int N, int M, class Env, bool Staged, class G, class Body>
DMPC_HD void horizon_pass(const RolloutArgs& a, const G& g, int b, Body& body, RolloutProfile& prof) {
  const int T = a.T;
  if constexpr (!Staged) {
    for (int t = 0; t < T; ++t) body(RolloutGlobal<N, M>{a, t, b}, t);
  } else {
    constexpr int kSize = RolloutSlice<N, M, Env>::kSize, kStages = rollout_stages<Env, G::kLanes>();
    g.sync();  // every lane is done with the slots' last contents
    prof.mark(kRolloutWait);
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < T) rollout_stage<N, M, Env>(a, g, s, b, stage_slot(g, s, kSize, kStages));
      else stream_commit();
    }
    prof.mark(kRolloutLoads);
    for (int t = 0; t < T; ++t) {
      stream_wait<kStages - 2>();  // this lane's copies of step t
      g.sync();                    // and every other lane's
      prof.mark(kRolloutWait);
      const int ahead = t + kStages - 1;
      if (ahead < T) rollout_stage<N, M, Env>(a, g, ahead, b, stage_slot(g, ahead, kSize, kStages));
      else stream_commit();
      prof.mark(kRolloutLoads);
      body(RolloutSlot<N, M, Env>{SlotReader{stage_slot(g, t, kSize, kStages), g.stride}, a.f != nullptr,
                                  a.u_lower != nullptr},
           t);
    }
  }
}

// A pass of the ladder: each local lane li advances its kPer states x[li][s]
// at step sizes step[li][s], adding their costs to obj[li][s]; state 0
// stores its trajectory in the lane's slot (xs, us themselves with one
// lane), and a later state that rolls out alpha_floor (at_floor[li][s], above
// one lane) in xs, us. With `base`, the baseline's stage costs are added to
// obj0.
template <int N, int M, int kLocal, int kPer, class Env, class G>
struct LadderBody {
  const RolloutArgs& a;
  const Env& env;
  const float* p;
  const G& g;
  int b;
  bool base;
  float& obj0;
  float (&step)[kLocal][kPer];
  float (&obj)[kLocal][kPer];
  float (&x)[kLocal][kPer][N];
  const bool (&at_floor)[kLocal][kPer];
  RolloutProfile& prof;

  template <class In>
  DMPC_HD void operator()(const In& in, int t) {
    constexpr int L = G::kLanes;
    const int B = a.B;
    if (base) {
      if constexpr (L < kRolloutShareBaselineLanes) {
        float xh[N], uh[M];
        for (int i = 0; i < N; ++i) xh[i] = in.xh(i);
        for (int i = 0; i < M; ++i) uh[i] = in.uh(i);
        obj0 = obj0 + stage_cost<N, M>(in, xh, uh);
      } else {
        obj0 = obj0 + baseline_stage_cost<N, M>(in, g);
      }
      prof.mark(kRolloutBase);
    }
    for (int li = 0; li < kLocal; ++li) {
#pragma unroll
      for (int s = 0; s < kPer; ++s) {
        float *xs = nullptr, *us = nullptr;
        size_t ld = 0;
        if (s == 0) {
          if constexpr (L == 1) {
            xs = a.xs + at(t, 0, N, B, b);
            us = a.us + at(t, 0, M, B, b);
            ld = (size_t)B;
          } else {
            const int lane = g.lane_of(li);
            xs = a.lane_x + lane_at(t, 0, N, B, b, L, lane);
            us = a.lane_u + lane_at(t, 0, M, B, b, L, lane);
            ld = (size_t)B * L;
          }
        } else if (L > 1 && at_floor[li][s]) {
          xs = a.xs + at(t, 0, N, B, b);
          us = a.us + at(t, 0, M, B, b);
          ld = (size_t)B;
        }
        rollout_step<N, M>(a, in, env, p, step[li][s], xs, us, ld, x[li][s], obj[li][s], prof);
      }
    }
  }
};

// The replay: one chain at step size alpha, which every lane runs on the
// same values, step t stored in xs, us by the lane that owns it.
template <int N, int M, class Env, class G>
struct ReplayBody {
  const RolloutArgs& a;
  const Env& env;
  const float* p;
  const G& g;
  int b;
  float alpha;
  float (&x)[N];
  float& obj;
  RolloutProfile& prof;

  template <class In>
  DMPC_HD void operator()(const In& in, int t) {
    const bool mine = g.owns(t);
    rollout_step<N, M>(a, in, env, p, alpha, mine ? a.xs + at(t, 0, N, a.B, b) : nullptr,
                       mine ? a.us + at(t, 0, M, a.B, b) : nullptr, (size_t)a.B, x, obj, prof);
  }
};

}  // namespace rollout_detail

// The line search for scenario b by the group of lanes g (HostLanes or
// CardLanes), its env's parameters read from `params` (a.params, or a
// block's copy of them in shared memory; null for linear dynamics), its
// slices staged through g's slots where Staged.
template <int N, int M, bool Staged, class Env, class G>
DMPC_HD void linesearch_rollout_scenario(const RolloutArgs& a, const Env& env, int b, const float* params,
                                         const G& g) {
  using namespace rollout_detail;
  constexpr int L = G::kLanes, kLocal = G::kLocal, kPer = rollout_pass_states<Env, L>();
  const int T = a.T, B = a.B;
  const float* p = params ? params + (size_t)b * a.params_stride : nullptr;
  RolloutProfile prof;
  float x0[N];
  for (int i = 0; i < N; ++i) x0[i] = a.x_init[(size_t)i * B + b];

  // The rolled ladder's alphas: lane j starts at decay^j, then steps by
  // decay^L from one of its candidates to the next, one float32 product at
  // a time: the serial loop's values.
  float al[kLocal];
  for (int li = 0; li < kLocal; ++li) {
    al[li] = 1.0f;
    for (int j = 0; j < g.lane_of(li); ++j) al[li] = al[li] * a.decay;
  }
  float obj0 = 0.0f, chosen = a.alpha_floor, chosen_obj = 0.0f;
  int chosen_lane = -1, chosen_state = -1;
  bool has = false;
  // each lane's first candidate of the last pass: its step and its cost;
  // where a later state of the lane rolled out alpha_floor into xs, us, its
  // cost
  float first_step[kLocal], first_obj[kLocal], direct_obj[kLocal];
  bool direct[kLocal];
  for (int k0 = 0; k0 < a.n_alpha && !has; k0 += L * kPer) {
    float step[kLocal][kPer], obj[kLocal][kPer], x[kLocal][kPer][N];
    bool at_floor[kLocal][kPer];
    for (int li = 0; li < kLocal; ++li) {
#pragma unroll
      for (int s = 0; s < kPer; ++s) {
        const int k = k0 + s * L + g.lane_of(li);
        // the candidate just past the ladder (in the last pass, where the
        // pass has room for it) rolls out alpha_floor: the trajectory of a
        // pick of no candidate, kept in the lane's slot (its first state)
        // or, above one lane, stored in xs, us (a later state)
        at_floor[li][s] = k == a.n_alpha;
        step[li][s] = at_floor[li][s] ? a.alpha_floor
                      : a.alphas   ? a.alphas[k < a.n_alpha ? k : a.n_alpha - 1]
                                   : al[li];
        for (int j = 0; j < L; ++j) al[li] = al[li] * a.decay;
        obj[li][s] = 0.0f;
        for (int i = 0; i < N; ++i) x[li][s][i] = x0[i];
      }
    }
    prof.mark(kRolloutInit);
    LadderBody<N, M, kLocal, kPer, Env, G> body{a, env, p, g, b, k0 == 0, obj0, step, obj, x, at_floor, prof};
    horizon_pass<N, M, Env, Staged>(a, g, b, body, prof);
    for (int li = 0; li < kLocal; ++li) {
      first_step[li] = step[li][0];
      first_obj[li] = obj[li][0];
      direct[li] = false;
      direct_obj[li] = 0.0f;
#pragma unroll
      for (int s = 1; s < kPer; ++s) {
        if (L > 1 && at_floor[li][s]) {
          direct[li] = true;
          direct_obj[li] = obj[li][s];
        }
      }
    }
    // the lowest improving candidate of the pass, state by state
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      bool improving[kLocal];
      float step_s[kLocal], obj_s[kLocal];
      for (int li = 0; li < kLocal; ++li) {
        improving[li] = k0 + s * L + g.lane_of(li) < a.n_alpha && obj[li][s] < obj0;
        step_s[li] = step[li][s];
        obj_s[li] = obj[li][s];
      }
      const int first = g.first_set(improving);
      if (first >= 0 && !has) {
        chosen = g.from_lane(step_s, first);
        chosen_obj = g.from_lane(obj_s, first);
        chosen_lane = first;
        chosen_state = s;
        has = true;
      }
    }
    prof.mark(kRolloutPick);
  }

  // the trajectory kept in a lane's slot (with one lane, already in xs, us):
  // the chosen lane's, where the pick was the lane's first candidate of its
  // pass; where none improves, a lane's whose first candidate of the last
  // pass stepped by alpha_floor's very bits (the lane past the ladder, or
  // the ladder's last step where it lands on them), or else alpha_floor's
  // rollout already in xs, us (a later state of the lane past the ladder):
  // the trajectory and cost the replay would give, bit for bit
  float objs = 0.0f;
  int kept = -1;
  bool replay = true;
  if (has && chosen_state == 0) {
    kept = chosen_lane;
    objs = chosen_obj;
    replay = false;
  } else if (!has) {
    bool on_floor[kLocal];
    for (int li = 0; li < kLocal; ++li) on_floor[li] = same_bits(first_step[li], a.alpha_floor);
    kept = g.first_set(on_floor);
    const int in_xs = kept >= 0 ? -1 : g.first_set(direct);
    if (kept >= 0) objs = g.from_lane(first_obj, kept);
    if (in_xs >= 0) objs = g.from_lane(direct_obj, in_xs);
    replay = kept < 0 && in_xs < 0;
  }
  if (kept >= 0) {
    if constexpr (L > 1) {
      g.publish();  // every lane's slot
      for (int li = 0; li < kLocal; ++li) {
        for (int t = g.lane_of(li); t < T; t += L) {
          for (int i = 0; i < N; ++i) a.xs[at(t, i, N, B, b)] = a.lane_x[lane_at(t, i, N, B, b, L, kept)];
          for (int i = 0; i < M; ++i) a.us[at(t, i, M, B, b)] = a.lane_u[lane_at(t, i, M, B, b, L, kept)];
        }
      }
    }
    prof.mark(kRolloutKeep);
  } else if (replay) {
    g.publish();  // after any lane's stores to xs, us
    float x[N];
    for (int i = 0; i < N; ++i) x[i] = x0[i];
    objs = 0.0f;
    prof.replay = true;
    ReplayBody<N, M, Env, G> body{a, env, p, g, b, chosen, x, objs, prof};
    horizon_pass<N, M, Env, Staged>(a, g, b, body, prof);
    prof.mark(kRolloutReplay);
  }
  if (g.leader()) {
    a.objs[b] = objs;
    a.alpha[b] = chosen;
    a.improved[b] = has ? 1.0f : 0.0f;
  }
  prof.flush(g.leader());
}
