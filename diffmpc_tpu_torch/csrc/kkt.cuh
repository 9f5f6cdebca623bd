// The analytic KKT backward of ONE scenario, by a group of L lanes.
//
// Counterpart of the TPU kernel bodies _make_kernel in
// diffmpc_tpu/ops/pallas/kkt.py (:164-242; the per-step math _aux_ric_step
// :71, _diff_roll_step :111, _mult_step :123, _cost_grad_entries :141,
// _dyn_grad_entries :153) and diffmpc_tpu/ops/pallas/kkt_stream.py
// (:49-200), computing what they compute, with a group of L threads
// (lanes.cuh: "lanes", L in 1, 2, 4, 16) in place of one lane of an
// (S, 128) tile. csrc/kkt.cu (the resident kernel) and csrc/kkt_stream.cu
// (its streaming twin) run it on the card (kkt_launch.cuh, the kernels built
// in kkt_l<L>.cu); the tests build it with g++ for the host, where the lanes
// of a group run one after another (HostLanes).
// diffmpc_tpu_torch/ops/cuda/kkt.py (kkt_backward_plain) is the same
// algorithm in plain PyTorch, vectorised over the batch. It depends on no
// env: the dynamics enter as F.
//
// Three sweeps over the horizon:
//   1. the auxiliary Riccati, backward: the Riccati sweep's own step in mask
//      mode (riccati.cuh: riccati_step at one lane, riccati_lanes_step above;
//      the tight control dims frozen, the linear term r, no f), the value
//      update full or (EXACT) simplified; its gains K, k are those of the
//      Riccati kernel in mask mode on (C, r, F, tight), bit for bit;
//   2. the zero-residual differential rollout p, forward from p_x = 0:
//      p_u = k + K p_x and p_x' = F p; writes dc = p and
//      dC = 1/2 (p tau' + tau p'), entry e by lane e % L;
//   3. the multiplier recursions, backward: lam (with (tau, c)) and mu (with
//      (p, r)); writes dF = -(mu_{t+1} tau' + lam_{t+1} p') and
//      df = -mu_{t+1}, entry e by lane e % L, and dx_init = -mu_0.
// Sweeps 2 and 3 are a few products a step (n rows of length n + m, twice
// over in sweep 3): every lane computes them whole, so that a step needs no
// exchange and no barrier, and the lanes share out the stores. Sharing the
// rows out over the lanes through the group's exchange, as sweep 1 shares
// its entries, took longer (16 lanes: 0.0419 against 0.0393 ms a call at the
// pendulum, T=20, B=1024, 0.480 against 0.415 at config 2, T=128, B=128;
// NVIDIA H100 80GB HBM3 at 700 W, diagnostics/ab_kkt_lanes). Each lane
// computes what it computes with the one-lane program's float32 operations
// in the same order (the sums of products fused by hand, riccati_mad, the
// sources built without contraction), so every L gives bit for bit the
// outputs of L = 1.
//
// Where the steps' inputs come from: above one lane each step's slice of
// sweep 1 is staged once for the group into a ring of shared-memory slots
// (lanes.cuh: entry e by lane e % L, kLaneStages - 1 steps ahead, read back
// by every lane); sweeps 2 and 3, and one lane's sweep 1, read each step's
// slice from device memory into registers at the step's start, every lane
// the whole slice (a group's loads of an entry are one address). C and F are
// read through strides (KktArgs): the
// batch-minor staging copy, or in place where one C or F serves every
// scenario. Where K, k and p live between the sweeps (OnChip): in the
// group's shared memory (the resident kernel, as the TPU kernel's VMEM
// scratch, kkt.py:312-316), or in device memory, K, k in the args' scratch
// and p as dc (the twin, as kkt_stream.py:49-200, and one lane on a full
// card), where a sweep stages them with its slice.
//
// Layout: every per-step array is batch-minor, (T, entries..., B), so that
// neighbouring threads touch neighbouring addresses.
#pragma once

#include <type_traits>

#include "riccati.cuh"

// Launch arguments. The field order is mirrored by ctypes in
// diffmpc_tpu_torch/ops/cuda/kkt.py (_KktArgs): keep the two in step.
struct KktArgs {
  // inputs
  const float* C;      // entry e = i * NM + j of step t, scenario b at t * C_t + e * C_e + b * C_b
  const float* c;      // (T, NM, B)
  const float* F;      // entry e = i * NM + j of step t, scenario b at t * F_t + e * F_e + b * F_b
  const float* r;      // (T, NM, B) incoming gradient, tight dims zeroed
  const float* tau;    // (T, NM, B) primal trajectory [x; u]
  const float* tight;  // (T, M, B) 1.0 where the control is at its bound
  // outputs
  float* dx_init;  // (N, B)
  float* dC;       // (T, NM, NM, B)
  float* dc;       // (T, NM, B); also the differential trajectory p
  float* dF;       // (T, N, NM, B)
  float* df;       // (T, N, B)
  // scratch, where the gains do not stay on chip
  float* K;  // (T, M, N, B) auxiliary feedback gains
  float* k;  // (T, M, B) auxiliary feedforward gains
  int T;
  int B;
  float reg;
  int lanes;    // threads per scenario, L
  int on_chip;  // K, k, p kept in shared memory: 1, or 0 in device memory; the resident
                // kernel's launcher chooses for < 0 and writes its choice back
  int prefetch;  // one lane: 1 loads the next step's slice while a step computes, 0 not; < 0 the
                 // launcher's choice, written back (more lanes always do)
  long long C_t, C_e, C_b;  // C's strides in elements
  long long F_t, F_e, F_b;  // F's strides in elements
};

namespace kkt_detail {

// element (t, i) of a batch-minor (T, D, B) array, for scenario b
DMPC_HD size_t at(int t, int i, int D, int B, int b) {
  return ((size_t)t * D + i) * (size_t)B + b;
}

// The arrays a slice is staged from: an entry of a slice is d * 16 + one of
// these, d its index along the array's entry dimension (C and F: i * NM + j).
enum KktArray { kArrC = 0, kArrc, kArrF, kArrr, kArrTau, kArrTight, kArrK, kArrk, kArrP };

}  // namespace kkt_detail

// Where entry d of array `arr` of step t lies for scenario b.
template <int N, int M>
DMPC_HD const float* kkt_src(const KktArgs& a, int arr, int d, int t, int b) {
  using namespace kkt_detail;
  constexpr int NM = N + M;
  const int B = a.B;
  switch (arr) {
    case kArrC: return a.C + (t * a.C_t + d * a.C_e + b * a.C_b);
    case kArrc: return a.c + at(t, d, NM, B, b);
    case kArrF: return a.F + (t * a.F_t + d * a.F_e + b * a.F_b);
    case kArrr: return a.r + at(t, d, NM, B, b);
    case kArrTau: return a.tau + at(t, d, NM, B, b);
    case kArrTight: return a.tight + at(t, d, M, B, b);
    case kArrK: return a.K + at(t, d, M * N, B, b);
    case kArrk: return a.k + at(t, d, M, B, b);
    default: return a.dc + at(t, d, NM, B, b);  // kArrP: p = dc
  }
}

// The three sweeps' slices. Sweep 1's is the Riccati sweep's in mask mode
// (RiccatiSlice): C's upper triangle, then r in place of c, F, f's N entries
// (never copied: no f), then tight in place of the mask. Sweep 2's: F, tau
// and (Dev: the gains in device memory) K, k. Sweep 3's: C's first N rows,
// c's and r's first N entries, F, tau and (Dev) p.
template <int N, int M, bool Dev>
struct KktSlice2 {
  static constexpr int NM = N + M;
  static constexpr int kTau = N * NM;
  static constexpr int kK = kTau + NM;
  static constexpr int kk = kK + M * N;
  static constexpr int kSize = Dev ? kk + M : kK;
};

template <int N, int M, bool Dev>
struct KktSlice3 {
  static constexpr int NM = N + M;
  static constexpr int kc = N * NM;
  static constexpr int kF = kc + N;
  static constexpr int kr = kF + N * NM;
  static constexpr int kTau = kr + N;
  static constexpr int kp = kTau + NM;
  static constexpr int kSize = Dev ? kp + NM : kp;
};

template <int SWEEP, int N, int M, bool Dev>
DMPC_HD constexpr int kkt_slice_size() {
  if constexpr (SWEEP == 1) return RiccatiSlice<N, M, kRiccatiMask>::kSize;
  if constexpr (SWEEP == 2) return KktSlice2<N, M, Dev>::kSize;
  return KktSlice3<N, M, Dev>::kSize;
}

// fn(e, array, d) for every entry e of sweep SWEEP's slice.
template <int SWEEP, int N, int M, bool Dev, class Fn>
DMPC_HD void kkt_slice_each(Fn&& fn) {
  using namespace kkt_detail;
  constexpr int NM = N + M;
  if constexpr (SWEEP == 1) {
    using S = RiccatiSlice<N, M, kRiccatiMask>;
    for (int i = 0; i < NM; ++i)
      for (int j = i; j < NM; ++j) fn(upper_index(NM, i, j), kArrC, i * NM + j);
    for (int i = 0; i < NM; ++i) fn(S::kc + i, kArrr, i);
    for (int i = 0; i < N * NM; ++i) fn(S::kF + i, kArrF, i);
    for (int i = 0; i < M; ++i) fn(S::kExtra + i, kArrTight, i);
  } else if constexpr (SWEEP == 2) {
    using S = KktSlice2<N, M, Dev>;
    for (int i = 0; i < N * NM; ++i) fn(i, kArrF, i);
    for (int i = 0; i < NM; ++i) fn(S::kTau + i, kArrTau, i);
    if constexpr (Dev) {
      for (int i = 0; i < M * N; ++i) fn(S::kK + i, kArrK, i);
      for (int i = 0; i < M; ++i) fn(S::kk + i, kArrk, i);
    }
  } else {
    using S = KktSlice3<N, M, Dev>;
    for (int i = 0; i < N * NM; ++i) fn(i, kArrC, i);
    for (int i = 0; i < N; ++i) fn(S::kc + i, kArrc, i);
    for (int i = 0; i < N * NM; ++i) fn(S::kF + i, kArrF, i);
    for (int i = 0; i < N; ++i) fn(S::kr + i, kArrr, i);
    for (int i = 0; i < NM; ++i) fn(S::kTau + i, kArrTau, i);
    if constexpr (Dev)
      for (int i = 0; i < NM; ++i) fn(S::kp + i, kArrP, i);
  }
}

// A step's slice in registers, read from device memory at once so that its
// loads are in flight together (one lane).
template <int Size>
struct KktRegs {
  float v[Size];
  DMPC_HD float operator[](int e) const { return v[e]; }
};

template <int SWEEP, int N, int M, bool Dev>
DMPC_HD KktRegs<kkt_slice_size<SWEEP, N, M, Dev>()> kkt_load(const KktArgs& a, int t, int b) {
  KktRegs<kkt_slice_size<SWEEP, N, M, Dev>()> r;
  kkt_slice_each<SWEEP, N, M, Dev>([&](int e, int arr, int d) { r.v[e] = *kkt_src<N, M>(a, arr, d, t, b); });
  return r;
}

// What one lane of a group of L > 1 copies of sweep 1's slice in every
// step, worked out once: entry lane + k L as d * 16 + array, -1 past the
// slice. Its share of the Riccati step is RiccatiLanePlan's.
template <int N, int M, int L>
struct KktLanePlan {
  static constexpr int kStage = (kkt_slice_size<1, N, M, false>() + L - 1) / L;
  int stage[kStage];

  DMPC_HD void init(int lane) {
    for (int k = 0; k < kStage; ++k) stage[k] = -1;
    kkt_slice_each<1, N, M, false>([&](int e, int arr, int d) {
      if (e % L == lane) stage[e / L] = d * 16 + arr;
    });
  }
};

// Start the copies of step t's slice of sweep 1 into `slot`, each lane its
// plan's entries.
template <int N, int M, class G, class Plan>
DMPC_HD void kkt_stage(const KktArgs& a, const G& g, const Plan (&plan)[G::kLocal], int t, int b, float* slot) {
  constexpr int L = G::kLanes;
  for (int li = 0; li < G::kLocal; ++li) {
    for (int k = 0; k < Plan::kStage; ++k) {
      const int p = plan[li].stage[k];
      if (p >= 0) stream_put(slot, g.stride, g.lane_of(li) + k * L, kkt_src<N, M>(a, p & 15, p >> 4, t, b));
    }
  }
  stream_commit();
}

// Floats a step's K, k and p take where they stay on chip.
template <int N, int M>
DMPC_HD constexpr int kkt_store_floats() {
  return M * N + M + N + M;
}

// Slots of a group's staging ring.
constexpr int kKktStages = kLaneStages;

// Floats of shared memory a group of L lanes needs over T steps: above one
// lane its ring of sweep 1's slices and the Riccati step's scratch; and
// (OnChip) K, k and p of every step.
template <int N, int M, int L, bool OnChip>
DMPC_HD constexpr long kkt_group_floats(int T) {
  return (L > 1 ? kKktStages * kkt_slice_size<1, N, M, false>() + RiccatiScratch<N, M>::kSize : 0) +
         (OnChip ? (long)T * kkt_store_floats<N, M>() : 0);
}

// Where sweep 1 puts the gains and sweep 2 the trajectory p: the group's
// shared memory (OnChip; `st`, T steps of kkt_store_floats entries), or
// device memory (K, k in the args' scratch; p is dc, which sweep 2 writes
// anyway). The Riccati step's sink (RiccatiOut's interface).
template <int N, int M, bool OnChip>
struct KktStore {
  static constexpr int kStep = kkt_store_floats<N, M>(), kk = M * N, kp = kk + M;
  const KktArgs& a;
  GroupScratch st;
  int b;
  DMPC_HD void K(int t, int i, int j, int, int, float val) const {
    if constexpr (OnChip) st[t * kStep + i * N + j] = val;
    else a.K[kkt_detail::at(t, i * N + j, M * N, a.B, b)] = val;
  }
  DMPC_HD void k(int t, int i, int, float val) const {
    if constexpr (OnChip) st[t * kStep + kk + i] = val;
    else a.k[kkt_detail::at(t, i, M, a.B, b)] = val;
  }
  DMPC_HD void free(int, int, int, float) const {}
  DMPC_HD void n_qp(int, float) const {}
  DMPC_HD void p(int t, int i, float val) const {
    if constexpr (OnChip) st[t * kStep + kp + i] = val;
  }
  DMPC_HD float K(int t, int i, int j) const { return st[t * kStep + i * N + j]; }
  DMPC_HD float k(int t, int i) const { return st[t * kStep + kk + i]; }
  DMPC_HD float p(int t, int i) const { return st[t * kStep + kp + i]; }
};

// Make this group's stores visible to its later loads (the gains and p
// between the sweeps: in device memory where they are not on chip), and
// every lane done with the ring before the next sweep.
template <class G>
DMPC_HD void kkt_between_sweeps(const G& g) {
#ifdef __CUDA_ARCH__
  __threadfence_block();
#endif
  g.sync();
}

// Sweep SWEEP over t (backward for 1 and 3, forward for 2): step(e, t) with
// e the step's slice, read from device memory into registers (KktRegs), with
// Prefetch while the step before computes, or
// (sweep 1 above one lane) a SlotReader on the group's staging ring (the
// start of g's slots), each step's slice copied once for the group,
// kKktStages - 1 steps ahead.
template <int SWEEP, int N, int M, bool Dev, bool Prefetch, class G, class Plan, class Step>
DMPC_HD void kkt_sweep(const KktArgs& a, const G& g, const Plan (&plan)[G::kLocal], int b, Step&& step) {
  constexpr bool kBackward = SWEEP != 2;
  const int T = a.T;
  auto t_of = [&](int s) { return kBackward ? T - 1 - s : s; };
  if constexpr (!Prefetch && (G::kLanes == 1 || SWEEP != 1)) {
    for (int s = 0; s < T; ++s) {
      const int t = t_of(s);
      step(kkt_load<SWEEP, N, M, Dev>(a, t, b), t);
    }
  } else if constexpr (G::kLanes == 1 || SWEEP != 1) {
    if (T == 0) return;
    auto cur = kkt_load<SWEEP, N, M, Dev>(a, t_of(0), b);
    for (int s = 0; s < T; ++s) {
      const int t = t_of(s);
      // the next step's slice, its loads in flight while this step computes
      const auto next = kkt_load<SWEEP, N, M, Dev>(a, s + 1 < T ? t_of(s + 1) : t, b);
      step(cur, t);
      cur = next;
    }
  } else {
    constexpr int kSize = kkt_slice_size<1, N, M, false>();
    auto slot = [&](int s) { return stage_slot(g, s, kSize, kKktStages); };
    for (int s = 0; s < kKktStages - 1; ++s) {
      if (s < T) kkt_stage<N, M>(a, g, plan, t_of(s), b, slot(s));
      else stream_commit();
    }
    for (int s = 0; s < T; ++s) {
      stream_wait<kKktStages - 2>();  // this lane's copies of step s
      g.sync();                       // and every other lane's; every lane is done with step s - 1's slot
      const int ahead = s + kKktStages - 1;
      if (ahead < T) kkt_stage<N, M>(a, g, plan, t_of(ahead), b, slot(ahead));
      else stream_commit();
      step(SlotReader{slot(s), g.stride}, t_of(s));
    }
    stream_wait<0>();
  }
}

// The backward of scenario b by the group of lanes g (HostLanes or
// CardLanes): K, k and p in the group's shared memory (OnChip) or in device
// memory; EXACT the auxiliary sweep's simplified value update; Prefetch
// kkt_sweep's. g's slots hold (L > 1) the ring and the Riccati step's
// scratch, then (OnChip) the store.
template <int N, int M, bool EXACT, bool OnChip, bool Prefetch = true, class G>
DMPC_HD void kkt_backward_group(const KktArgs& a, const G& g, int b) {
  constexpr int L = G::kLanes, NM = N + M;
  constexpr bool Dev = !OnChip;
  using S2 = KktSlice2<N, M, Dev>;
  using S3 = KktSlice3<N, M, Dev>;
  const int T = a.T, B = a.B;
  constexpr long kRing = L > 1 ? (long)kKktStages * kkt_slice_size<1, N, M, false>() : 0;
  constexpr long kShared = L > 1 ? kRing + RiccatiScratch<N, M>::kSize : 0;
  const GroupScratch x{g.slots + kRing * g.stride, g.stride};
  const KktStore<N, M, OnChip> store{a, GroupScratch{g.slots + kShared * g.stride, g.stride}, b};
  KktLanePlan<N, M, L> plan[G::kLocal];
  RiccatiLanePlan<N, M, kRiccatiMask, L> ric[G::kLocal];
  if constexpr (L > 1)
    for (int li = 0; li < G::kLocal; ++li) {
      plan[li].init(g.lane_of(li));
      ric[li].init(g.lane_of(li), false);
    }

  // ---- 1. the auxiliary Riccati, backward: the Riccati step in mask mode ----
  {
    float V[N][N], v[N];
    for (int i = 0; i < N; ++i) {
      v[i] = 0.0f;
      for (int j = 0; j < N; ++j) V[i][j] = 0.0f;
    }
    kkt_sweep<1, N, M, Dev, Prefetch>(a, g, plan, b, [&](const auto& e, int t) {
      const RiccatiSlot<N, M, kRiccatiMask, std::decay_t<decltype(e)>> in{e, false};
      if constexpr (L == 1) {
        float K[M][N], kt[M], frozen[M];
        riccati_step<N, M, kRiccatiMask>(in, 0, a.reg, V, v, K, kt, frozen, EXACT);
        for (int i = 0; i < M; ++i) {
          for (int j = 0; j < N; ++j) store.K(t, i, j, M, N, K[i][j]);
          store.k(t, i, M, kt[i]);
        }
      } else {
        riccati_lanes_step<N, M, kRiccatiMask, kPnqpEnumDefault>(g, ric, x, in, t, a.reg, 0, EXACT, store, V, v);
      }
    });
  }
  kkt_between_sweeps(g);

  // ---- 2. the differential rollout, forward: dc = p, dC ----
  {
    float px[N];
    for (int i = 0; i < N; ++i) px[i] = 0.0f;
    kkt_sweep<2, N, M, Dev, Prefetch>(a, g, plan, b, [&](const auto& e, int t) {
      // p = [p_x; k + K p_x]
      float p[NM], tau[NM];
      for (int i = 0; i < N; ++i) p[i] = px[i];
      for (int c = 0; c < M; ++c) {
        float s = 0.0f;
        for (int j = 0; j < N; ++j) s = riccati_mad<true>(Dev ? e[S2::kK + c * N + j] : store.K(t, c, j), px[j], s);
        p[N + c] = (Dev ? e[S2::kk + c] : store.k(t, c)) + s;
      }
      for (int i = 0; i < NM; ++i) tau[i] = e[S2::kTau + i];
      // dc = p (and on chip), dC = 1/2 (p tau' + tau p'): entry e by lane e % L
      for (int li = 0; li < G::kLocal; ++li) {
        const int lane = g.lane_of(li);
        for (int i = lane; i < NM; i += L) {
          a.dc[kkt_detail::at(t, i, NM, B, b)] = p[i];
          store.p(t, i, p[i]);
        }
        for (int q = lane; q < NM * NM; q += L) {
          const int i = q / NM, j = q % NM;
          a.dC[kkt_detail::at(t, q, NM * NM, B, b)] = 0.5f * (p[i] * tau[j] + tau[i] * p[j]);
        }
      }
      // p_x' = F p
      for (int i = 0; i < N; ++i) {
        float s = 0.0f;
        for (int j = 0; j < NM; ++j) s = riccati_mad<true>(e[i * NM + j], p[j], s);
        px[i] = s;
      }
    });
  }
  kkt_between_sweeps(g);

  // ---- 3. the multipliers, backward: dF, df, dx_init ----
  float lam[N], mu[N];  // lam_{t+1}, mu_{t+1}; zero at t = T-1
  for (int i = 0; i < N; ++i) lam[i] = mu[i] = 0.0f;
  kkt_sweep<3, N, M, Dev, Prefetch>(a, g, plan, b, [&](const auto& e, int t) {
    float p[NM], tau[NM];
    for (int i = 0; i < NM; ++i) {
      p[i] = Dev ? e[S3::kp + i] : store.p(t, i);
      tau[i] = e[S3::kTau + i];
    }
    // df = -mu_{t+1}, dF = -(mu_{t+1} tau' + lam_{t+1} p'): entry e by lane e % L
    for (int li = 0; li < G::kLocal; ++li) {
      const int lane = g.lane_of(li);
      for (int i = lane; i < N; i += L) a.df[kkt_detail::at(t, i, N, B, b)] = -mu[i];
      for (int q = lane; q < N * NM; q += L) {
        const int i = q / NM, j = q % NM;
        a.dF[kkt_detail::at(t, q, N * NM, B, b)] = -(mu[i] * tau[j] + lam[i] * p[j]);
      }
    }
    // lam_t = -(C tau + c)_x + Fx' lam_{t+1}, mu_t = -(C p + r)_x + Fx' mu_{t+1}
    float lam_t[N], mu_t[N];
    for (int i = 0; i < N; ++i) {
      float ct = 0.0f, cp = 0.0f, fl = 0.0f, fm = 0.0f;
      for (int j = 0; j < NM; ++j) {
        ct = riccati_mad<true>(e[i * NM + j], tau[j], ct);
        cp = riccati_mad<true>(e[i * NM + j], p[j], cp);
      }
      for (int k = 0; k < N; ++k) {
        fl = riccati_mad<true>(e[S3::kF + k * NM + i], lam[k], fl);
        fm = riccati_mad<true>(e[S3::kF + k * NM + i], mu[k], fm);
      }
      lam_t[i] = -(ct + e[S3::kc + i]) + fl;
      mu_t[i] = -(cp + e[S3::kr + i]) + fm;
    }
    for (int i = 0; i < N; ++i) {
      lam[i] = lam_t[i];
      mu[i] = mu_t[i];
    }
  });
  for (int li = 0; li < G::kLocal; ++li)
    for (int i = g.lane_of(li); i < N; i += L) a.dx_init[(size_t)i * B + b] = -mu[i];
}
