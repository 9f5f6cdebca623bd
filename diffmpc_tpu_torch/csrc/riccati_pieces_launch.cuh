// The piece sweep's kernels and their launch (riccati_pieces.cuh): a group of
// L threads per scenario, L a template argument, in both read modes.
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

template <int VARIANT, int L, bool Staged>
int launch(const PieceArgs* a, const PendulumEnv* env, cudaStream_t stream) {
  const long threads = (long)a->B * L;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  const size_t smem = Staged ? sizeof(float) * (kThreads / L) * piece_group_slot_floats() : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(piece_sweep_kernel<VARIANT, L, Staged>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (blocks > 0) piece_sweep_kernel<VARIANT, L, Staged><<<blocks, kThreads, smem, stream>>>(*a, *env);
  return static_cast<int>(cudaGetLastError());
}

// The sweep in `variant` (a PieceVariant) at L lanes, staged or reading
// device memory as a->staged says; returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unknown variant.
template <int L>
int sweep_launch(const PieceArgs* a, const PendulumEnv* env, int variant, cudaStream_t s) {
  const bool staged = a->staged != 0;
  switch (variant) {
#define DMPC_PIECE_CASE(V_)                                                     \
  case V_:                                                                      \
    return staged ? launch<V_, L, true>(a, env, s) : launch<V_, L, false>(a, env, s);
    DMPC_PIECE_CASE(kPieceFull)
    DMPC_PIECE_CASE(kPieceNoLin)
    DMPC_PIECE_CASE(kPieceNoQform)
    DMPC_PIECE_CASE(kPieceNoPnqp)
    DMPC_PIECE_CASE(kPieceNoVup)
#undef DMPC_PIECE_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace pieces_launch_detail

// Declare the sweep's kernels at L lanes as built in riccati_pieces_l<L>.cu,
// or build them there.
#define DMPC_PIECES_EXTERN(_, L) \
  extern template int pieces_launch_detail::sweep_launch<L>(const PieceArgs*, const PendulumEnv*, int, cudaStream_t);
#define DMPC_PIECES_INSTANTIATE(L) \
  template int pieces_launch_detail::sweep_launch<L>(const PieceArgs*, const PendulumEnv*, int, cudaStream_t);
