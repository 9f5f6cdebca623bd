// The Riccati backward sweep of ONE scenario, in three modes, by a group of
// L lanes.
//
// Counterpart of the TPU kernel bodies _make_kernel in
// diffmpc_tpu/ops/pallas/riccati.py (:521-613) and
// diffmpc_tpu/ops/pallas/riccati_stream.py (:43-168), computing what they
// compute, with a group of L threads (lanes.cuh: "lanes", L in 1, 2, 4, 16)
// in place of one lane of an (S, 128) tile. csrc/riccati.cu (the resident
// kernel) and csrc/riccati_stream.cu (its streaming twin) run it on the card
// (riccati_launch.cuh, the kernels built in riccati_l<L>.cu); the tests build
// it with g++ for the host, where the lanes of a group run one after another
// (HostLanes). diffmpc_tpu_torch/ops/cuda/riccati.py
// (riccati_backward_plain) is the same algorithm in plain PyTorch,
// vectorised over the batch.
//
// Per step t = T-1..0, with the value carry (V, v) in registers, the step's
// inputs read through an accessor (RiccatiSlot: of registers that the step
// loads from device memory at its start, RiccatiRegs; or, Staged, of a
// shared-memory slot that the group fills a few steps ahead):
//   W = V F, z = V f + v, Q = C + F'W (upper triangle, mirrored), q = c + F'z;
//   free: [K k] = -(Quu + reg)^-1 [Qux qu];
//   box:  k from the box QP on [lo_t, hi_t], K from the masked solve with
//         the clamped dims frozen;
//   mask: [K k] from the masked solve with the given dims frozen;
//   then the value update, full or (RiccatiArgs::exact_update) simplified.
//
// One lane (riccati_step) computes the step as one thread. A group of L > 1
// lanes shares it out (riccati_lanes_step), each entry computed by one lane
// with the one-thread program's float32 operations in the same order, and
// exchanged through the group's scratch in shared memory (RiccatiScratch):
// - the entries of Q's upper triangle and of q, entry e by lane e % L, each
//   with the column of W (or z) it needs;
// - the box QP's candidates where it enumerates (m = 2's nine; m = 3's 27
//   under the mode "1", ENUM: the clipped Newton point, then the
//   enumeration's codes), candidate c by lane c % L; every lane then folds
//   the objectives in candidate order by the enumeration's strict "<", so a
//   NaN is never replaced and a tie keeps the earlier candidate; where it
//   loops (projected Newton: m = 3, and m = 2 under "0"), each step's
//   Armijo candidates, candidate a by lane a % L, the first improving one
//   taken by a ballot (pnqp_loop_lanes), and the loop left once the QP is
//   done on every thread of the group's mask;
// - the gains' columns (K's, then the qu column for k in free and mask
//   modes), column c by lane c % L, on a factor every lane computes;
// - the entries of V' (upper triangle) and v', entry e by lane e % L.
// So every L gives bit for bit the outputs of L = 1.
//
// Layout: every per-step array is batch-minor, (T, entries..., B), so that
// neighbouring threads touch neighbouring addresses.
#pragma once

#include "lanes.cuh"
#include "riccati_entries.cuh"

enum RiccatiMode { kRiccatiFree = 0, kRiccatiBox = 1, kRiccatiMask = 2 };

// Launch arguments. The field order is mirrored by ctypes in
// diffmpc_tpu_torch/ops/cuda/riccati.py (_RiccatiArgs): keep the two in step.
struct RiccatiArgs {
  // inputs
  const float* C;     // (T, NM, NM, B)
  const float* c;     // (T, NM, B)
  const float* F;     // (T, N, NM, B)
  const float* f;     // (T, N, B), or null for zeros
  const float* lo;    // (T, M, B) box mode: u_lower - u_hat
  const float* hi;    // (T, M, B) box mode: u_upper - u_hat
  const float* mask;  // (T, M, B) mask mode: 1.0 where the control is frozen
  // outputs
  float* K;     // (T, M, N, B)
  float* k;     // (T, M, B)
  float* free;  // (T, M, B) 1.0 where the control is free
  float* n_qp;  // (T, B) box mode: box-QP solves
  int T;
  int B;
  int pnqp_iter;
  float reg;
  int lanes;         // threads per scenario, L
  int exact_update;  // 1: the simplified value update (value_update's EXACT)
  int staged;        // one lane: 1 stages each step's slice, 0 reads device memory, < 0 the launcher's
                     // choice, written back (riccati_launch.cuh); more lanes stage
};

namespace riccati_detail {

// element (t, i) of a batch-minor (T, D, B) array, for scenario b
DMPC_HD size_t at(int t, int i, int D, int B, int b) {
  return ((size_t)t * D + i) * (size_t)B + b;
}

}  // namespace riccati_detail

// Step t's inputs for scenario b, read from the args' device memory. An
// accessor gives C(i, j) for j >= i, c(i), F(i, j), has_f() and f(i), lo(i),
// hi(i) (box mode) and mask(i) (mask mode).
template <int N, int M>
struct RiccatiGlobal {
  static constexpr int NM = N + M;
  const RiccatiArgs& a;
  int t;
  int b;
  DMPC_HD float C(int i, int j) const { return a.C[riccati_detail::at(t, i * NM + j, NM * NM, a.B, b)]; }
  DMPC_HD float c(int i) const { return a.c[riccati_detail::at(t, i, NM, a.B, b)]; }
  DMPC_HD float F(int i, int j) const { return a.F[riccati_detail::at(t, i * NM + j, N * NM, a.B, b)]; }
  DMPC_HD bool has_f() const { return a.f != nullptr; }
  DMPC_HD float f(int i) const { return a.f[riccati_detail::at(t, i, N, a.B, b)]; }
  DMPC_HD float lo(int i) const { return a.lo[riccati_detail::at(t, i, M, a.B, b)]; }
  DMPC_HD float hi(int i) const { return a.hi[riccati_detail::at(t, i, M, a.B, b)]; }
  DMPC_HD float mask(int i) const { return a.mask[riccati_detail::at(t, i, M, a.B, b)]; }
};

// The step's quadratic model from its inputs `in` and the next value (V, v):
// W = V F, z = V f + v, Q = C + F'W (upper triangle, mirrored), q = c + F'z;
// with F, each sum of products fused term by term (riccati_mad).
template <int N, int M, bool F = false, class In>
DMPC_HD void riccati_q_form(const In& in, const float (&V)[N][N], const float (&v)[N], float (&Q)[N + M][N + M],
                            float (&q)[N + M]) {
  constexpr int NM = N + M;
  float Ft[N][NM];
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < NM; ++j) Ft[i][j] = in.F(i, j);
  // W = V F ; z = V f + v
  float W[N][NM], z[N];
  for (int k = 0; k < N; ++k) {
    for (int j = 0; j < NM; ++j) {
      float s2 = 0.0f;
      for (int l = 0; l < N; ++l) s2 = riccati_mad<F>(V[k][l], Ft[l][j], s2);
      W[k][j] = s2;
    }
    float s2 = 0.0f;
    if (in.has_f())
      for (int l = 0; l < N; ++l) s2 = riccati_mad<F>(V[k][l], in.f(l), s2);
    z[k] = s2 + v[k];
  }
  // Q = C + F'W (upper triangle of C, mirrored) ; q = c + F'z
  for (int i = 0; i < NM; ++i)
    for (int j = i; j < NM; ++j) {
      float s2 = 0.0f;
      for (int k = 0; k < N; ++k) s2 = riccati_mad<F>(Ft[k][i], W[k][j], s2);
      Q[i][j] = in.C(i, j) + s2;
      Q[j][i] = Q[i][j];
    }
  for (int i = 0; i < NM; ++i) {
    float s2 = 0.0f;
    for (int k = 0; k < N; ++k) s2 = riccati_mad<F>(Ft[k][i], z[k], s2);
    q[i] = in.c(i) + s2;
  }
}

// The control blocks of (Q, q): Quu, qu and the columns of Qux.
template <int N, int M>
DMPC_HD void riccati_control_blocks(const float (&Q)[N + M][N + M], const float (&q)[N + M], float (&Quu)[M][M],
                                    float (&qu)[M], float (&cols)[N][M]) {
  for (int i = 0; i < M; ++i) {
    for (int j = 0; j < M; ++j) Quu[i][j] = Q[N + i][N + j];
    qu[i] = q[N + i];
    for (int j = 0; j < N; ++j) cols[j][i] = Q[N + i][j];  // column j of Qux
  }
}

// Free-mode gains: [K k] = -(Quu + reg)^-1 [Qux qu].
template <int N, int M, bool F = false>
DMPC_HD void riccati_free_gains(const float (&Quu)[M][M], const float (&qu)[M], const float (&cols)[N][M], float reg,
                                float (&K)[M][N], float (&kt)[M]) {
  float L[M][M], col[M];
  chol_entries<M, F>(Quu, reg, L);
  for (int j = 0; j < N; ++j) {
    cho_solve_entries<M, F>(L, cols[j], col);
    for (int i = 0; i < M; ++i) K[i][j] = -col[i];
  }
  cho_solve_entries<M, F>(L, qu, col);
  for (int i = 0; i < M; ++i) kt[i] = -col[i];
}

// A free-mode step without its value update: the gains at this step from its
// inputs and the next value (V, v). The depth-blocked sweep
// (riccati_blocked.cuh) recovers its gains with it.
template <int N, int M, class In>
DMPC_HD void riccati_gains_free(const In& in, float reg, const float (&V)[N][N], const float (&v)[N],
                                float (&K)[M][N], float (&kt)[M]) {
  float Q[N + M][N + M], q[N + M], Quu[M][M], qu[M], cols[N][M];
  riccati_q_form<N, M>(in, V, v, Q, q);
  riccati_control_blocks<N, M>(Q, q, Quu, qu, cols);
  riccati_free_gains<N, M>(Quu, qu, cols, reg, K, kt);
}

// One step of the sweep by one thread: the gains K, k and the frozen mask at
// this step from its inputs `in` and the value carry (V, v), which it updates
// in place (with `exact`, by the simplified value update), its sums of
// products fused as the helpers' F says. Returns the box QP's solve count (0
// outside box mode).
template <int N, int M, int MODE, int ENUM = kPnqpEnumDefault, class In>
DMPC_HD float riccati_step(const In& in, int pnqp_iter, float reg, float (&V)[N][N], float (&v)[N],
                           float (&K)[M][N], float (&kt)[M], float (&frozen)[M], bool exact = false) {
  constexpr int NM = N + M;
  float Q[NM][NM], q[NM], Quu[M][M], qu[M], cols[N][M];
  riccati_q_form<N, M, true>(in, V, v, Q, q);
  riccati_control_blocks<N, M>(Q, q, Quu, qu, cols);
  float n_qp = 0.0f;
  if constexpr (MODE == kRiccatiBox) {
    float lo[M], hi[M], Kc[N][M];
    for (int i = 0; i < M; ++i) {
      lo[i] = in.lo(i);
      hi[i] = in.hi(i);
    }
    n_qp = pnqp_entries<M, true, ENUM>(Quu, qu, lo, hi, pnqp_iter, reg, kt, frozen);
    masked_chol_solve<M, N, true>(Quu, cols, frozen, reg, Kc);
    for (int i = 0; i < M; ++i)
      for (int j = 0; j < N; ++j) K[i][j] = -Kc[j][i];
  } else if constexpr (MODE == kRiccatiMask) {
    float rhs[N + 1][M], sol[N + 1][M];  // the columns of Qux, then qu
    for (int i = 0; i < M; ++i) {
      frozen[i] = in.mask(i);
      for (int j = 0; j < N; ++j) rhs[j][i] = cols[j][i];
      rhs[N][i] = qu[i];
    }
    masked_chol_solve<M, N + 1, true>(Quu, rhs, frozen, reg, sol);
    for (int i = 0; i < M; ++i) {
      for (int j = 0; j < N; ++j) K[i][j] = -sol[j][i];
      kt[i] = -sol[N][i];
    }
  } else {
    riccati_free_gains<N, M, true>(Quu, qu, cols, reg, K, kt);
    for (int i = 0; i < M; ++i) frozen[i] = 0.0f;
  }
  if (exact)
    value_update<N, M, true, true>(Q, q, Quu, qu, K, kt, V, v);
  else
    value_update<N, M, false, true>(Q, q, Quu, qu, K, kt, V, v);
  return n_qp;
}

// Where a lane group's step puts what it computes (riccati_lanes_step): the
// sweep's outputs for scenario b, entry by entry. The KKT backward's
// auxiliary sweep (kkt.cuh) takes the same step with a sink of its own.
struct RiccatiOut {
  const RiccatiArgs& a;
  int b;
  DMPC_HD void K(int t, int i, int j, int M, int N, float val) const {
    a.K[riccati_detail::at(t, i * N + j, M * N, a.B, b)] = val;
  }
  DMPC_HD void k(int t, int i, int M, float val) const { a.k[riccati_detail::at(t, i, M, a.B, b)] = val; }
  DMPC_HD void free(int t, int i, int M, float val) const { a.free[riccati_detail::at(t, i, M, a.B, b)] = val; }
  DMPC_HD void n_qp(int t, float val) const { a.n_qp[(size_t)t * a.B + b] = val; }
};

// Write step t's gains, free mask and (box mode) QP count for scenario b.
template <int N, int M, int MODE>
DMPC_HD void riccati_store(const RiccatiArgs& a, int t, int b, const float (&K)[M][N], const float (&kt)[M],
                           const float (&frozen)[M], float n_qp) {
  using riccati_detail::at;
  for (int i = 0; i < M; ++i) {
    for (int j = 0; j < N; ++j) a.K[at(t, i * N + j, M * N, a.B, b)] = K[i][j];
    a.k[at(t, i, M, a.B, b)] = kt[i];
    a.free[at(t, i, M, a.B, b)] = 1.0f - frozen[i];
  }
  if constexpr (MODE == kRiccatiBox) a.n_qp[(size_t)t * a.B + b] = n_qp;
}

// One step's staged slice: C's upper triangle (row by row), c, F, f, then
// lo, hi (box mode) or the mask (mask mode). f is copied only when the args
// have it.
template <int N, int M, int MODE>
struct RiccatiSlice {
  static constexpr int NM = N + M;
  static constexpr int kc = NM * (NM + 1) / 2;
  static constexpr int kF = kc + NM;
  static constexpr int kf = kF + N * NM;
  static constexpr int kExtra = kf + N;
  static constexpr int kSize = kExtra + (MODE == kRiccatiBox ? 2 * M : MODE == kRiccatiMask ? M : 0);
};

// Step inputs from a slice (a staging slot, or E = RiccatiRegs): the
// accessor of riccati_step.
template <int N, int M, int MODE, class E = SlotReader>
struct RiccatiSlot {
  using S = RiccatiSlice<N, M, MODE>;
  E e;
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

// A step's slice in registers, read from device memory at once so that its
// loads are in flight together (one lane on a full card: the step with its
// Q form and value update fused by hand, reading each entry where it needs
// it, took 0.216 against the unfused step's 0.191 ms a call, config 2 at
// T=20, B=65,536, NVIDIA H100 80GB HBM3 at 700 W, ab_riccati_lanes).
template <int N, int M, int MODE>
struct RiccatiRegs {
  float v[RiccatiSlice<N, M, MODE>::kSize];
  DMPC_HD float operator[](int e) const { return v[e]; }
};

// Step t's slice of scenario b, in RiccatiSlice's layout (f's entries zero
// where the args lack it).
template <int N, int M, int MODE>
DMPC_HD RiccatiRegs<N, M, MODE> riccati_load(const RiccatiArgs& a, int t, int b) {
  using riccati_detail::at;
  using S = RiccatiSlice<N, M, MODE>;
  constexpr int NM = N + M;
  const int B = a.B;
  RiccatiRegs<N, M, MODE> r;
  for (int i = 0; i < NM; ++i)
    for (int j = i; j < NM; ++j) r.v[upper_index(NM, i, j)] = a.C[at(t, i * NM + j, NM * NM, B, b)];
  for (int i = 0; i < NM; ++i) r.v[S::kc + i] = a.c[at(t, i, NM, B, b)];
  for (int i = 0; i < N * NM; ++i) r.v[S::kF + i] = a.F[at(t, i, N * NM, B, b)];
  for (int i = 0; i < N; ++i) r.v[S::kf + i] = a.f ? a.f[at(t, i, N, B, b)] : 0.0f;
  for (int i = 0; i < M; ++i) {
    if constexpr (MODE == kRiccatiBox) {
      r.v[S::kExtra + i] = a.lo[at(t, i, M, B, b)];
      r.v[S::kExtra + M + i] = a.hi[at(t, i, M, B, b)];
    } else if constexpr (MODE == kRiccatiMask) {
      r.v[S::kExtra + i] = a.mask[at(t, i, M, B, b)];
    }
  }
  return r;
}

// Start this lane's share of the copies of step t's slice into `slot`.
template <int N, int M, int MODE, class G>
DMPC_HD void riccati_stage(const RiccatiArgs& a, const G& g, int t, int b, float* slot) {
  using riccati_detail::at;
  using S = RiccatiSlice<N, M, MODE>;
  constexpr int NM = N + M;
  const int B = a.B;
  for (int i = 0; i < NM; ++i)
    for (int j = i; j < NM; ++j) stage_put(g, slot, upper_index(NM, i, j), &a.C[at(t, i * NM + j, NM * NM, B, b)]);
  for (int i = 0; i < NM; ++i) stage_put(g, slot, S::kc + i, &a.c[at(t, i, NM, B, b)]);
  for (int i = 0; i < N * NM; ++i) stage_put(g, slot, S::kF + i, &a.F[at(t, i, N * NM, B, b)]);
  if (a.f)
    for (int i = 0; i < N; ++i) stage_put(g, slot, S::kf + i, &a.f[at(t, i, N, B, b)]);
  for (int i = 0; i < M; ++i) {
    if constexpr (MODE == kRiccatiBox) {
      stage_put(g, slot, S::kExtra + i, &a.lo[at(t, i, M, B, b)]);
      stage_put(g, slot, S::kExtra + M + i, &a.hi[at(t, i, M, B, b)]);
    } else if constexpr (MODE == kRiccatiMask) {
      stage_put(g, slot, S::kExtra + i, &a.mask[at(t, i, M, B, b)]);
    }
  }
  stream_commit();
}

// Built with DMPC_RICCATI_PROFILE (a diagnostic build), the first thread of
// block 0 adds the cycles of each phase of riccati_lanes_step to
// riccati_profile_cycles (read back by diffmpc_riccati_profile).
#ifdef DMPC_RICCATI_PROFILE
static __device__ unsigned long long riccati_profile_cycles[12];
#endif
struct RiccatiProfile {
#if defined(DMPC_RICCATI_PROFILE) && defined(__CUDA_ARCH__)
  bool on = blockIdx.x == 0 && threadIdx.x == 0;
  long long last = clock64();
  __device__ void mark(int phase) {
    const long long now = clock64();
    if (on) riccati_profile_cycles[phase] += now - last;
    last = now;
  }
#else
  DMPC_HD void mark(int) {}
#endif
};

// The QP candidates a group shares out through its scratch: the 3^M - 1
// codes of the enumeration (m = 2; m = 3 under the mode "1") after the
// clipped Newton point, which every lane computes itself (it starts the
// fold, and a lane computes it beside its own candidate). Elsewhere every
// lane solves the QP itself: m = 1's closed form, and the projected-Newton
// loop, whose Armijo candidates a ballot picks from (pnqp_loop_lanes).
template <int M, int ENUM>
DMPC_HD constexpr int riccati_split_candidates() {
  if constexpr (pnqp_enumerates<M, ENUM>()) {
    int c = 1;
    for (int i = 0; i < M; ++i) c *= 3;
    return c - 1;
  }
  return 0;
}

// The exchange scratch of a group of L > 1 lanes, in floats: Q's upper
// triangle (upper_index) and q; each split QP candidate's objective and
// point; K (row-major) and k; V's upper triangle and v.
template <int N, int M, int ENUM = kPnqpEnumDefault>
struct RiccatiScratch {
  static constexpr int NM = N + M;
  static constexpr int kq = NM * (NM + 1) / 2;
  static constexpr int kCand = kq + NM;
  static constexpr int kCandidates = riccati_split_candidates<M, ENUM>();
  static constexpr int kK = kCand + kCandidates * (M + 1);
  static constexpr int kk = kK + M * N;
  static constexpr int kV = kk + M;
  static constexpr int kv = kV + N * (N + 1) / 2;
  static constexpr int kSize = kv + N;
};

// Entry e of a group's scratch, entries `stride` apart.
struct GroupScratch {
  float* p;
  int stride;
  DMPC_HD float& operator[](int e) const { return p[(size_t)e * stride]; }
};

// (i, j), j >= i, of entry e of an n x n upper triangle stored row by row:
// upper_index's inverse.
DMPC_HD void upper_rc(int n, int e, int& i, int& j) {
  i = 0;
  while (e >= n - i) {
    e -= n - i;
    ++i;
  }
  j = i + e;
}

// What one lane of a group of L takes in every step, worked out once per
// sweep: the entries of the staged slice it copies (entry lane + k L as
// d * 8 + array, d the entry's index along its array's entry dimension;
// -1 past the slice or for an f the args lack), the entries of Q's upper
// triangle and q it computes (plan_entry(i, j), or plan_vector(i) for q[i];
// -1 past them) and the entries of the updated value (plan_entry(a, b) for
// V'(a, b), plan_vector(a) for v'(a); -1 past them).
// A plan's code of matrix entry (i, j), i and j below 2^kPlanBits, and of
// vector entry i: kPlanVector and above.
constexpr int kPlanBits = 5, kPlanMask = (1 << kPlanBits) - 1, kPlanVector = 1 << (2 * kPlanBits);
DMPC_HD constexpr int plan_entry(int i, int j) { return i + (j << kPlanBits); }
DMPC_HD constexpr int plan_vector(int i) { return kPlanVector + i; }

template <int N, int M, int MODE, int L>
struct RiccatiLanePlan {
  static constexpr int NM = N + M, kT = N * (N + 1) / 2;
  static_assert(NM <= kPlanMask + 1, "a plan codes the entries of Q in kPlanBits bits each");
  static constexpr int kSlice = RiccatiSlice<N, M, MODE>::kSize;
  static constexpr int kStage = (kSlice + L - 1) / L;
  static constexpr int kQ = (RiccatiScratch<N, M>::kCand + L - 1) / L;
  static constexpr int kV = (kT + N + L - 1) / L;
  int stage[kStage], q[kQ], v[kV];

  DMPC_HD void init(int lane, bool has_f) {
    using Sl = RiccatiSlice<N, M, MODE>;
    constexpr int kq = NM * (NM + 1) / 2;
    for (int k = 0; k < kStage; ++k) {
      const int e = lane + k * L;
      int i, j;
      if (e < Sl::kc) {
        upper_rc(NM, e, i, j);
        stage[k] = (i * NM + j) * 8 + 0;
      } else if (e < Sl::kF) {
        stage[k] = (e - Sl::kc) * 8 + 1;
      } else if (e < Sl::kf) {
        stage[k] = (e - Sl::kF) * 8 + 2;
      } else if (e < Sl::kExtra) {
        stage[k] = has_f ? (e - Sl::kf) * 8 + 3 : -1;
      } else if (e < kSlice) {
        // box: lo then hi; mask: the mask
        const int d = e - Sl::kExtra;
        stage[k] = MODE == kRiccatiBox ? (d < M ? d * 8 + 4 : (d - M) * 8 + 5) : d * 8 + 6;
      } else {
        stage[k] = -1;
      }
    }
    for (int k = 0; k < kQ; ++k) {
      const int e = lane + k * L;
      int i, j;
      if (e < kq) {
        upper_rc(NM, e, i, j);
        q[k] = plan_entry(i, j);
      } else {
        q[k] = e < kq + NM ? plan_vector(e - kq) : -1;
      }
    }
    for (int k = 0; k < kV; ++k) {
      const int e = lane + k * L;
      int a, b;
      if (e < kT) {
        upper_rc(N, e, a, b);
        v[k] = plan_entry(a, b);
      } else {
        v[k] = e < kT + N ? plan_vector(e - kT) : -1;
      }
    }
  }
};

// Start the copies of step t's slice into `slot`, each lane its plan's
// entries.
template <int N, int M, int MODE, class G, class Plan>
DMPC_HD void riccati_stage_planned(const RiccatiArgs& a, const G& g, const Plan (&plan)[G::kLocal], int t, int b,
                                   float* slot) {
  constexpr int NM = N + M, L = G::kLanes;
  const float* const base[7] = {a.C, a.c, a.F, a.f, a.lo, a.hi, a.mask};
  constexpr int dims[7] = {NM * NM, NM, N * NM, N, M, M, M};
  for (int li = 0; li < G::kLocal; ++li) {
    for (int k = 0; k < Plan::kStage; ++k) {
      const int p = plan[li].stage[k];
      if (p < 0) continue;
      const float* src = base[0];
      int D = dims[0];
      for (int s = 1; s < 7; ++s) {
        if ((p & 7) == s) {
          src = base[s];
          D = dims[s];
        }
      }
      stream_put(slot, g.stride, g.lane_of(li) + k * L, src + ((size_t)t * D + (p >> 3)) * (size_t)a.B + b);
    }
  }
  stream_commit();
}

// Entry (i, j), j >= i, of the step's Q (or, q, q[i]) as riccati_q_form
// computes it for riccati_step: W's column j (or z) first, then the entry.
template <int N, int M, class In>
DMPC_HD float riccati_q_entry(const In& in, const float (&V)[N][N], const float (&v)[N], bool isq, int i, int j) {
  float W[N];
  for (int k = 0; k < N; ++k) {
    float s2 = 0.0f;
    if (!isq || in.has_f())
      for (int l = 0; l < N; ++l) s2 = riccati_mad<true>(V[k][l], isq ? in.f(l) : in.F(l, j), s2);
    W[k] = isq ? s2 + v[k] : s2;
  }
  float s2 = 0.0f;
  for (int k = 0; k < N; ++k) s2 = riccati_mad<true>(in.F(k, i), W[k], s2);
  return (isq ? in.c(i) : in.C(i, j)) + s2;
}

// Entry V'(a, b), b >= a, of the updated value (or v'(a)) from the group's
// scratch, as value_update computes it for riccati_step (with `exact`, its
// simplified form).
template <int N, int M, int ENUM>
DMPC_HD float riccati_v_entry(const GroupScratch& x, const float (&Quu)[M][M], const float (&qu)[M],
                              const float (&kt)[M], bool isv, int a, int b, bool exact) {
  using S = RiccatiScratch<N, M, ENUM>;
  constexpr int NM = N + M;
  if (!isv) {
    float ab = 0.0f, ba = 0.0f;
    for (int r = 0; r < M; ++r) ab = riccati_mad<true>(x[upper_index(NM, a, N + r)], x[S::kK + r * N + b], ab);
    for (int r = 0; r < M; ++r) ba = riccati_mad<true>(x[upper_index(NM, b, N + r)], x[S::kK + r * N + a], ba);
    const float Qab = x[upper_index(NM, a, b)];
    if (exact) return Qab + 0.5f * (ab + ba);
    float kqk = 0.0f;
    for (int r = 0; r < M; ++r) {
      float QuuK = 0.0f;
      for (int s = 0; s < M; ++s) QuuK = riccati_mad<true>(Quu[r][s], x[S::kK + s * N + b], QuuK);
      kqk = riccati_mad<true>(x[S::kK + r * N + a], QuuK, kqk);
    }
    return Qab + ab + ba + kqk;
  }
  float s1 = 0.0f;
  for (int r = 0; r < M; ++r) s1 = riccati_mad<true>(x[upper_index(NM, a, N + r)], kt[r], s1);
  if (exact) return x[S::kq + a] + s1;
  float s2 = 0.0f;
  for (int r = 0; r < M; ++r) {
    float Quuk = 0.0f;
    for (int s = 0; s < M; ++s) Quuk = riccati_mad<true>(Quu[r][s], kt[s], Quuk);
    s2 = riccati_mad<true>(x[S::kK + r * N + a], qu[r] + Quuk, s2);
  }
  return x[S::kq + a] + s1 + s2;
}

// One step of the sweep by the group g of L > 1 lanes (the header says what
// each lane takes; `plan`, each local lane's share), its exchanges through
// the scratch x: the gains of step t put to `out` (RiccatiOut, or the KKT
// backward's and the fused solve's sinks), each entry by the lane that
// computed it (k, the free mask and the QP count by lane N % L), and the
// value carry (V, v), which every lane holds whole, updated in place.
// Returns the box QP's solve count, on every lane (0 outside box mode).
template <int N, int M, int MODE, int ENUM, class In, class G, class Plan, class Out>
DMPC_HD float riccati_lanes_step(const G& g, const Plan (&plan)[G::kLocal], const GroupScratch& x, const In& in, int t,
                                 float reg, int pnqp_iter, bool exact, const Out& out, float (&V)[N][N],
                                 float (&v)[N]) {
  using S = RiccatiScratch<N, M, ENUM>;
  constexpr int L = G::kLanes, NM = N + M;
  RiccatiProfile prof;

  // Q's upper triangle and q
  for (int li = 0; li < G::kLocal; ++li) {
    for (int k = 0; k < Plan::kQ; ++k) {
      const int p = plan[li].q[k];
      if (p < 0) continue;
      const bool isq = p >= kPlanVector;
      const int i = isq ? p - kPlanVector : p & kPlanMask, j = p >> kPlanBits;
      x[isq ? S::kq + i : upper_index(NM, i, j)] = riccati_q_entry<N, M>(in, V, v, isq, i, j);
    }
  }
  prof.mark(0);
  g.sync();
  float Quu[M][M], qu[M];
  for (int i = 0; i < M; ++i) {
    for (int j = 0; j < M; ++j) Quu[i][j] = x[upper_index(NM, N + (i < j ? i : j), N + (i < j ? j : i))];
    qu[i] = x[S::kq + N + i];
  }
  prof.mark(1);

  // the box QP, or the given frozen dims
  float kt[M], frozen[M], n_qp = 0.0f;
  if constexpr (MODE == kRiccatiBox) {
    float lo[M], hi[M];
    for (int i = 0; i < M; ++i) {
      lo[i] = in.lo(i);
      hi[i] = in.hi(i);
    }
    if constexpr (S::kCandidates > 0) {
      // candidate c = 1 .. 3^M - 1 by lane (c - 1) % L; the clipped Newton
      // point, candidate 0, by every lane
      for (int li = 0; li < G::kLocal; ++li) {
        for (int c = 1 + g.lane_of(li); c <= S::kCandidates; c += L) {
          float xc[M];
          const float o = pnqp_enum_candidate<M, true>(c, Quu, qu, lo, hi, reg, xc);
          x[S::kCand + (c - 1) * (M + 1)] = o;
          for (int i = 0; i < M; ++i) x[S::kCand + (c - 1) * (M + 1) + 1 + i] = xc[i];
        }
      }
      float best_obj = pnqp_enum_candidate<M, true>(0, Quu, qu, lo, hi, reg, kt);
      prof.mark(2);
      g.sync();
      prof.mark(3);
      // the enumeration's fold: the first least objective by a strict "<"
      // (a NaN is never replaced)
      int best = 0;
      for (int c = 1; c <= S::kCandidates; ++c) {
        const float o = x[S::kCand + (c - 1) * (M + 1)];
        if (o < best_obj) {
          best = c;
          best_obj = o;
        }
      }
      if (best > 0)
        for (int i = 0; i < M; ++i) kt[i] = x[S::kCand + (best - 1) * (M + 1) + 1 + i];
      qp_frozen<M, true>(Quu, qu, lo, hi, kt, frozen);
      n_qp = 1.0f;
      prof.mark(4);
    } else if constexpr (M == 1) {
      n_qp = pnqp_entries<M, true, ENUM>(Quu, qu, lo, hi, pnqp_iter, reg, kt, frozen);
    } else {
      // the projected-Newton loop, its Armijo candidates shared out
      n_qp = pnqp_loop_lanes<M>(g, Quu, qu, lo, hi, pnqp_iter, reg, kt);
      qp_frozen<M>(Quu, qu, lo, hi, kt, frozen);
      prof.mark(2);
    }
  } else {
    for (int i = 0; i < M; ++i) frozen[i] = MODE == kRiccatiMask ? in.mask(i) : 0.0f;
  }

  // the gains: every lane factors, lane c % L solves column c (K's columns,
  // then in free and mask modes the qu column, whose solution is -k)
  constexpr int kCols = MODE == kRiccatiBox ? N : N + 1;
  float fr[M], Lf[M][M], inv1 = 0.0f;
  if constexpr (MODE == kRiccatiFree) {
    chol_entries<M, true>(Quu, reg, Lf);
  } else {
    for (int i = 0; i < M; ++i) fr[i] = 1.0f - frozen[i];
    if constexpr (M == 1) {
      inv1 = 1.0f / (Quu[0][0] * fr[0] + frozen[0] + reg);
    } else {
      float Am[M][M];
      for (int i = 0; i < M; ++i)
        for (int j = 0; j < M; ++j) Am[i][j] = Quu[i][j] * fr[i] * fr[j] + (i == j ? frozen[i] : 0.0f);
      chol_entries<M, true>(Am, reg, Lf);
    }
  }
  prof.mark(5);
  for (int li = 0; li < G::kLocal; ++li) {
    const int lane = g.lane_of(li);
    for (int c = lane; c < kCols; c += L) {
      float rhs[M], sol[M];
      for (int i = 0; i < M; ++i) rhs[i] = c < N ? x[upper_index(NM, c, N + i)] : qu[i];
      if constexpr (MODE == kRiccatiFree) {
        cho_solve_entries<M, true>(Lf, rhs, sol);
      } else if constexpr (M == 1) {
        sol[0] = rhs[0] * fr[0] * inv1;
      } else {
        float col[M];
        for (int i = 0; i < M; ++i) col[i] = rhs[i] * fr[i];
        cho_solve_entries<M, true>(Lf, col, sol);
      }
      for (int i = 0; i < M; ++i) {
        const float val = -sol[i];
        if (c < N) {
          x[S::kK + i * N + c] = val;
          out.K(t, i, c, M, N, val);
        } else {
          x[S::kk + i] = val;
          out.k(t, i, M, val);
        }
      }
    }
    if (lane == N % L) {
      for (int i = 0; i < M; ++i) {
        if constexpr (MODE == kRiccatiBox) out.k(t, i, M, kt[i]);
        out.free(t, i, M, 1.0f - frozen[i]);
      }
      if constexpr (MODE == kRiccatiBox) out.n_qp(t, n_qp);
    }
  }
  prof.mark(6);
  g.sync();
  prof.mark(7);
  if constexpr (MODE != kRiccatiBox)
    for (int i = 0; i < M; ++i) kt[i] = x[S::kk + i];

  // the value update
  for (int li = 0; li < G::kLocal; ++li) {
    for (int k = 0; k < Plan::kV; ++k) {
      const int p = plan[li].v[k];
      if (p < 0) continue;
      const bool isv = p >= kPlanVector;
      const int i = isv ? p - kPlanVector : p & kPlanMask, j = p >> kPlanBits;
      x[isv ? S::kv + i : S::kV + upper_index(N, i, j)] = riccati_v_entry<N, M, ENUM>(x, Quu, qu, kt, isv, i, j, exact);
    }
  }
  prof.mark(8);
  g.sync();
  for (int i = 0; i < N; ++i) {
    for (int j = i; j < N; ++j) {
      V[i][j] = x[S::kV + upper_index(N, i, j)];
      V[j][i] = V[i][j];
    }
    v[i] = x[S::kv + i];
  }
  prof.mark(9);
  return n_qp;
}

// Slots of a group's staging ring: the group computes step t while the
// copies of the next riccati_stages - 2 steps are in flight: four at one lane
// (the pendulum's twin at T=256, B=1024: 0.142 against 0.162 ms a call with
// the double buffer), three above (two changed nothing at 16 lanes: 0.3043
// against 0.3031 at T=128, B=128; NVIDIA H100 80GB HBM3 at 700 W,
// diagnostics/ab_riccati_lanes).
template <int L>
DMPC_HD constexpr int riccati_stages() {
  return L == 1 ? 4 : 3;
}

// Floats of shared memory a group of L lanes needs: its ring of slices
// (Staged) and, above one lane, its exchange scratch
template <int N, int M, int MODE, bool Staged, int L, int ENUM = kPnqpEnumDefault>
DMPC_HD constexpr int riccati_group_floats() {
  return (Staged ? riccati_stages<L>() * RiccatiSlice<N, M, MODE>::kSize : 0) +
         (L > 1 ? RiccatiScratch<N, M, ENUM>::kSize : 0);
}

// The sweep t = T-1..0 of scenario b by the group of lanes g (HostLanes or
// CardLanes), its inputs read from device memory (riccati_load), or (Staged) from the
// group's staging ring, each step's slice copied once for the group,
// riccati_stages - 1 steps ahead. g's slots hold the ring, then the scratch.
// One lane runs riccati_step, a group of more riccati_lanes_step; ENUM is
// the box QP's enumeration mode.
template <int N, int M, int MODE, bool Staged, int ENUM = kPnqpEnumDefault, class G>
DMPC_HD void riccati_sweep(const RiccatiArgs& a, const G& g, int b) {
  constexpr int L = G::kLanes, kSize = RiccatiSlice<N, M, MODE>::kSize, kStages = riccati_stages<L>();
  using Plan = RiccatiLanePlan<N, M, MODE, L>;
  const int T = a.T;
  const bool exact = a.exact_update != 0;
  const GroupScratch x{g.slots + (size_t)(Staged ? kStages * kSize : 0) * g.stride, g.stride};
  Plan plan[G::kLocal];
  if constexpr (L > 1)
    for (int li = 0; li < G::kLocal; ++li) plan[li].init(g.lane_of(li), a.f != nullptr);
  float V[N][N], v[N];
  for (int i = 0; i < N; ++i) {
    v[i] = 0.0f;
    for (int j = 0; j < N; ++j) V[i][j] = 0.0f;
  }
  auto step = [&](const auto& in, int t) {
    if constexpr (L == 1) {
      float K[M][N], kt[M], frozen[M];
      const float n_qp = riccati_step<N, M, MODE, ENUM>(in, a.pnqp_iter, a.reg, V, v, K, kt, frozen, exact);
      riccati_store<N, M, MODE>(a, t, b, K, kt, frozen, n_qp);
    } else {
      riccati_lanes_step<N, M, MODE, ENUM>(g, plan, x, in, t, a.reg, a.pnqp_iter, exact, RiccatiOut{a, b}, V, v);
    }
  };
  auto stage = [&](int t, float* slot) {
    if constexpr (L == 1)
      riccati_stage<N, M, MODE>(a, g, t, b, slot);
    else
      riccati_stage_planned<N, M, MODE>(a, g, plan, t, b, slot);
  };
  if constexpr (!Staged) {
    for (int s = 0; s < T; ++s) {
      const int t = T - 1 - s;
      step(RiccatiSlot<N, M, MODE, RiccatiRegs<N, M, MODE>>{riccati_load<N, M, MODE>(a, t, b), a.f != nullptr}, t);
    }
  } else {
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < T) stage(T - 1 - s, stage_slot(g, s, kSize, kStages));
      else stream_commit();
    }
    for (int s = 0; s < T; ++s) {
      RiccatiProfile prof;
      stream_wait<kStages - 2>();  // this lane's copies of step s
      g.sync();                    // and every other lane's; every lane is done with step s - 1's slot
      prof.mark(10);
      const int ahead = s + kStages - 1;
      if (ahead < T) stage(T - 1 - ahead, stage_slot(g, ahead, kSize, kStages));
      else stream_commit();
      prof.mark(11);
      step(RiccatiSlot<N, M, MODE>{SlotReader{stage_slot(g, s, kSize, kStages), g.stride}, a.f != nullptr}, T - 1 - s);
    }
  }
}
