// The fused iLQR kernel and its launch, for any env: a group of L threads
// per scenario (ilqr.cuh), L a template argument.
//
// ilqr.cu (the pendulum) and ilqr_nn_l<L>.cu (the MLPs of nn_archs.cuh, one
// file per lane count, so that nvcc builds them side by side; ilqr_nn.cu
// holds their launchers) instantiate it for their envs, with and without the
// HoistLin pre-pass, at the lane counts of DMPC_LANES (lanes.cuh), with the
// default box QP and value update; variants/ilqr.cu instantiates any other
// MLP, enumeration mode (ENUM) or value update (EXACT) at first use. An env whose
// parameters are shared by every scenario and fit in shared memory
// (SharedParams, the MLP's) has them copied there once per block before any
// group starts its scenario; the pendulum reads its three, or its
// per-scenario row, from device memory.
// With L > 1 each group also stages its rollouts' step slices in its own
// column of the block's dynamic shared memory.
#pragma once

#include <cuda_runtime.h>

#include "ilqr.cuh"
#include "nn_mlp.cuh"

namespace ilqr_launch_detail {

constexpr int kThreads = 128;

template <class Env, bool HoistLin, int L, int ENUM, bool EXACT>
__global__ void __launch_bounds__(kThreads) ilqr_kernel(IlqrArgs a, Env env) {
  constexpr int P = SharedParams<Env>::count;
  extern __shared__ float ilqr_slots[];
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int b = (int)(tid / L);
  const CardLanes<L> g = card_lanes<L>(ilqr_slots, kThreads);
  if constexpr (P > 0) {
    __shared__ float params[P];
    for (int i = threadIdx.x; i < P; i += blockDim.x) params[i] = a.params[i];
    __syncthreads();
    if (b >= a.B) return;  // the whole group: its lanes share b
    ilqr_solve_scenario<Env::N, Env::M, HoistLin, ENUM, EXACT>(a, env, b, params, g);
  } else {
    if (b >= a.B) return;
    ilqr_solve_scenario<Env::N, Env::M, HoistLin, ENUM, EXACT>(a, env, b, g);
  }
}

// Launch the kernel for Env at L lanes, the box QP's enumeration mode ENUM
// and the value update's form EXACT (ilqr.cuh, riccati_sweep); returns
// cudaGetLastError().
template <class Env, bool HoistLin, int L, int ENUM = kPnqpEnumDefault, bool EXACT = false>
int launch(const IlqrArgs* args, const Env* env, cudaStream_t stream) {
  if (!ilqr_lane_scratch_ok<Env, L>(*args)) return static_cast<int>(cudaErrorInvalidValue);
  const long threads = (long)args->B * L;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  const size_t smem = L > 1 ? sizeof(float) * (kThreads / L) * ilqr_group_slot_floats<Env::N, Env::M>() : 0;
  // above 48 KB of shared memory a block must ask for it: (6, 3) at two and
  // four lanes, 64 / 32 groups' rings of 378 floats, beside an MLP's weights
  if (smem + sizeof(float) * SharedParams<Env>::count > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(ilqr_kernel<Env, HoistLin, L, ENUM, EXACT>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (blocks > 0) ilqr_kernel<Env, HoistLin, L, ENUM, EXACT><<<blocks, kThreads, smem, stream>>>(*args, *env);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ilqr_launch_detail

// Declare the launches of Env's kernels at L lanes, with and without
// HoistLin, as built in another file, or build them in this one.
#define DMPC_ILQR_EXTERN(Env, L)                                                                           \
  extern template int ilqr_launch_detail::launch<Env, false, L>(const IlqrArgs*, const Env*, cudaStream_t); \
  extern template int ilqr_launch_detail::launch<Env, true, L>(const IlqrArgs*, const Env*, cudaStream_t);
#define DMPC_ILQR_INSTANTIATE(Env, L)                                                               \
  template int ilqr_launch_detail::launch<Env, false, L>(const IlqrArgs*, const Env*, cudaStream_t); \
  template int ilqr_launch_detail::launch<Env, true, L>(const IlqrArgs*, const Env*, cudaStream_t);

// Launch the solve on `stream` with args->lanes threads per scenario;
// returns cudaGetLastError(), or cudaErrorInvalidValue for a lane count that
// is not instantiated (DMPC_LANES, lanes.cuh) or lanes' trajectory
// scratch that its groups would not use, or lack.
template <class Env, bool HoistLin, int ENUM = kPnqpEnumDefault, bool EXACT = false>
int ilqr_launch(const IlqrArgs* args, const Env* env, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (args->lanes) {
#define DMPC_ILQR_LANE_CASE(_, L_) \
  case L_:                         \
    return ilqr_launch_detail::launch<Env, HoistLin, L_, ENUM, EXACT>(args, env, s);
    DMPC_LANES(DMPC_ILQR_LANE_CASE, _)
#undef DMPC_ILQR_LANE_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
