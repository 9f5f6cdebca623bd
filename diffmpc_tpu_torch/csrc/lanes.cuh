// A group of L lanes that works on ONE scenario, and the staging of its
// step slices.
//
// The fused iLQR solve (ilqr.cuh), the line-search rollout (rollout.cuh),
// the Riccati sweep (riccati.cuh) and the KKT backward (kkt.cuh), each
// resident kernel and its streaming twin, give each scenario a group of
// L threads ("lanes", L in 1, 2, 4, 16, all in one warp). The same source
// runs on the card, where the lanes are L neighbouring threads of a warp
// (CardLanes: a warp barrier, a ballot, a shuffle), and in the tests' g++
// build, where the lanes of a group run one after another (HostLanes: every
// per-lane value an array over the lanes). L = 1 is the one-thread program.
//
// Staging: each step's slice of the horizon arrays is copied once for the
// group into one of a ring of slots in shared memory, the entries split over
// the lanes (entry e by lane e % L), as many steps ahead of the step the
// group computes as the ring has slots but one (stream.cuh's cp.async), and
// read back by every lane as a broadcast.
#pragma once

#include "dual.cuh"
#include "stream.cuh"

// Slots of the fused solve's staging ring: the group computes step t while
// the copies of t + 1 .. t + kLaneStages - 2 are in flight (the line search
// takes its own, rollout_stages in rollout.cuh).
constexpr int kLaneStages = 3;

// The lane counts the kernels are instantiated for, X(A, L) for each: on the
// card (ilqr_launch.cuh, rollout_launch.cuh, riccati_launch.cuh) and in the
// host build of the tests. They are the ones the wrappers' rules pick
// (ops/cuda/ilqr.py, ILQR_LANES, ilqr_lanes, rollout_lanes and
// riccati_lanes), L = 1 among them; the MLPs' kernels are built one file per
// lane count, ilqr_nn_l<L>.cu and rollout_nn_l<L>.cu (the tests hold the
// lists equal). The Riccati sweep's card kernels take only the counts of
// DMPC_RICCATI_LANES (riccati_launch.cuh), one file each, riccati_l<L>.cu,
// and the KKT backward's those of DMPC_KKT_LANES (kkt_launch.cuh),
// kkt_l<L>.cu.
#define DMPC_LANES(X, A) X(A, 1) X(A, 2) X(A, 4) X(A, 16)

// The lanes of one scenario in the host build: they run one after another,
// so every per-lane value is an array over the lanes (kLocal = L), the
// common work runs once and stores every step, and the staging slots are
// one local buffer, entries 1 apart, that a lane fills whole.
template <int L>
struct HostLanes {
  static constexpr int kLanes = L;
  static constexpr int kLocal = L;
  float* slots;  // the ring of staging slots of a slice
  static constexpr int stride = 1;
  DMPC_HD int lane_of(int li) const { return li; }
  DMPC_HD bool leader() const { return true; }
  DMPC_HD bool owns(int) const { return true; }
  DMPC_HD bool copies(int) const { return true; }
  DMPC_HD void sync() const {}
  DMPC_HD void publish() const {}
  // the lowest lane whose flag is set, or -1
  DMPC_HD int first_set(const bool (&flag)[kLocal]) const {
    for (int l = 0; l < L; ++l)
      if (flag[l]) return l;
    return -1;
  }
  DMPC_HD float from_lane(const float (&v)[kLocal], int lane) const { return v[lane]; }
  // whether v holds: a value of the common work, which runs once
  DMPC_HD bool all(bool v) const { return v; }
};

// The lanes of one scenario on the card: L neighbouring threads of a warp,
// each holding its own lane's values (kLocal = 1). `slots` is the group's
// column of the block's staging memory, entries `stride` (groups per block)
// apart; each lane copies the entries e with e % L == lane.
template <int L>
struct CardLanes {
  static constexpr int kLanes = L;
  static constexpr int kLocal = 1;
  int lane;
  unsigned mask;  // the group's threads in the warp
  int shift;      // the group's first thread in the warp
  float* slots;
  int stride;
  DMPC_HD int lane_of(int) const { return lane; }
  DMPC_HD bool leader() const { return lane == 0; }
  DMPC_HD bool owns(int t) const {
    if constexpr (L == 1) return true;
    return t % L == lane;
  }
  DMPC_HD bool copies(int e) const {
    if constexpr (L == 1) return true;
    return e % L == lane;
  }
  // every lane's copies of a slot arrived, and every lane is done with the
  // slot before it is refilled
  DMPC_HD void sync() const {
#ifdef __CUDA_ARCH__
    if constexpr (L > 1) __syncwarp(mask);
#endif
  }
  // make this lane's stores to device memory visible to the group's later
  // loads and copies
  DMPC_HD void publish() const {
#ifdef __CUDA_ARCH__
    if constexpr (L > 1) {
      __threadfence_block();
      __syncwarp(mask);
    }
#endif
  }
  // the group's lowest lane whose flag is set, or -1 (every thread of
  // `mask` votes; the group's own lanes count)
  DMPC_HD int first_set(const bool (&flag)[1]) const {
#ifdef __CUDA_ARCH__
    if constexpr (L > 1) {
      const unsigned bits = (__ballot_sync(mask, flag[0]) >> shift) & ((1u << L) - 1u);
      return bits ? __ffs(bits) - 1 : -1;
    }
#endif
    return flag[0] ? 0 : -1;
  }
  // whether v holds on every thread of `mask`: the group's, or where a
  // kernel's groups synchronise together (riccati_launch.cuh), the warp's
  DMPC_HD bool all(bool v) const {
#ifdef __CUDA_ARCH__
    if constexpr (L > 1) return __all_sync(mask, v);
#endif
    return v;
  }
  DMPC_HD float from_lane(const float (&v)[1], int src) const {
#ifdef __CUDA_ARCH__
    if constexpr (L > 1) return __shfl_sync(mask, v[0], src, L);
#endif
    return v[0];
  }
};

#ifdef __CUDACC__
// This thread's group of L lanes in a block of `threads` threads, its staging
// column at `smem` (the block's dynamic shared memory, threads / L columns).
template <int L>
__device__ __forceinline__ CardLanes<L> card_lanes(float* smem, int threads) {
  static_assert(L <= 16 && 32 % L == 0, "a group of lanes lies within one warp");
  const int warp_lane = threadIdx.x & 31;
  const int shift = warp_lane - warp_lane % L;
  return CardLanes<L>{(int)(threadIdx.x % L), ((1u << L) - 1u) << shift, shift, smem + threadIdx.x / L, threads / L};
}
#endif

// Start this lane's copy of entry e of a slot, if the entry is its own.
template <class G>
DMPC_HD void stage_put(const G& g, float* slot, int e, const float* src) {
  if (g.copies(e)) stream_put(slot, g.stride, e, src);
}

// The group's staging slot of step t, in a ring of `stages` slots of
// slices of `size` entries
template <class G>
DMPC_HD float* stage_slot(const G& g, int t, int size, int stages) {
  return g.slots + (size_t)(t % stages) * size * g.stride;
}

// element (t, i) of lane `lane`'s slot in a batch-minor (T, D, B, L) array,
// for scenario b
DMPC_HD size_t lane_at(int t, int i, int D, int B, int b, int L, int lane) {
  return (((size_t)t * D + i) * (size_t)B + b) * (size_t)L + lane;
}
