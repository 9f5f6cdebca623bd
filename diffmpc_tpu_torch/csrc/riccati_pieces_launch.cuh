// The piece kernels and their launch (riccati_pieces.cuh): the sweep and the
// rollout by a group of L threads per scenario, L a template argument, in
// both read modes.
//
// riccati_pieces_l<L>.cu instantiate them, one file per lane count of
// DMPC_LANES (lanes.cuh), so that nvcc builds them side by side;
// riccati_pieces.cu holds the launchers.
#pragma once

#include <cuda_runtime.h>

#include "riccati_pieces.cuh"

namespace pieces_launch_detail {

constexpr int kThreads = 128;

template <int VARIANT, int L, bool Staged>
__global__ void __launch_bounds__(kThreads) piece_sweep_kernel(PieceArgs a, PendulumEnv env) {
  extern __shared__ float piece_slots[];
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int b = (int)(tid / L);
  const CardLanes<L> g = card_lanes<L>(piece_slots, kThreads);
  if (b >= a.B) return;  // the whole group: its lanes share b
  piece_sweep_scenario<VARIANT, Staged>(a, env, b, g);
}

template <int L, bool Staged>
__global__ void __launch_bounds__(kThreads) piece_rollout_kernel(PieceArgs a, PendulumEnv env) {
  extern __shared__ float piece_slots[];
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int b = (int)(tid / L);
  const CardLanes<L> g = card_lanes<L>(piece_slots, kThreads);
  if (b >= a.B) return;  // the whole group: its lanes share b
  piece_rollout_scenario<Staged>(a, env, b, g);
}

// Launch `kernel` for a->B scenarios at L lanes, with the group's staging
// rings where Staged: kThreads / L rings a block, 39 KB at one lane and
// 2.5 KB at 16, within the 48 KB a launch takes without an attribute.
template <int L, bool Staged>
int launch(void (*kernel)(PieceArgs, PendulumEnv), const PieceArgs* a, const PendulumEnv* env,
           cudaStream_t stream) {
  const long threads = (long)a->B * L;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  const size_t smem = Staged ? sizeof(float) * (kThreads / L) * piece_group_slot_floats() : 0;
  static_assert(sizeof(float) * kThreads * kLaneStages * pieces_detail::PieceSlice::kSize <= 48 * 1024,
                "a block's staging rings fit the default dynamic shared memory");
  if (blocks > 0) kernel<<<blocks, kThreads, smem, stream>>>(*a, *env);
  return static_cast<int>(cudaGetLastError());
}

// The sweep in `variant` (a PieceVariant) at L lanes, staged or reading
// device memory as a->staged says; returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unknown variant.
template <int L>
int sweep_launch(const PieceArgs* a, const PendulumEnv* env, int variant, cudaStream_t s) {
  const bool staged = a->staged != 0;
  switch (variant) {
#define DMPC_PIECE_CASE(V_)                                                                    \
  case V_:                                                                                     \
    return staged ? launch<L, true>(piece_sweep_kernel<V_, L, true>, a, env, s)                \
                  : launch<L, false>(piece_sweep_kernel<V_, L, false>, a, env, s);
    DMPC_PIECE_CASE(kPieceFull)
    DMPC_PIECE_CASE(kPieceNoLin)
    DMPC_PIECE_CASE(kPieceNoQform)
    DMPC_PIECE_CASE(kPieceNoPnqp)
    DMPC_PIECE_CASE(kPieceNoVup)
#undef DMPC_PIECE_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The rollout at L lanes, staged or reading device memory as a->staged
// says; returns cudaGetLastError().
template <int L>
int rollout_launch(const PieceArgs* a, const PendulumEnv* env, cudaStream_t s) {
  return a->staged ? launch<L, true>(piece_rollout_kernel<L, true>, a, env, s)
                   : launch<L, false>(piece_rollout_kernel<L, false>, a, env, s);
}

}  // namespace pieces_launch_detail

// Declare the kernels at L lanes as built in riccati_pieces_l<L>.cu, or
// build them there.
#define DMPC_PIECES_EXTERN(_, L)                                                                                    \
  extern template int pieces_launch_detail::sweep_launch<L>(const PieceArgs*, const PendulumEnv*, int, cudaStream_t); \
  extern template int pieces_launch_detail::rollout_launch<L>(const PieceArgs*, const PendulumEnv*, cudaStream_t);
#define DMPC_PIECES_INSTANTIATE(L)                                                                           \
  template int pieces_launch_detail::sweep_launch<L>(const PieceArgs*, const PendulumEnv*, int, cudaStream_t); \
  template int pieces_launch_detail::rollout_launch<L>(const PieceArgs*, const PendulumEnv*, cudaStream_t);
