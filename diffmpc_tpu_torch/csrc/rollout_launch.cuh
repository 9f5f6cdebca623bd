// The line-search rollout kernels and their launch, for any env: a group of
// L threads per scenario (rollout.cuh), L a template argument, the step
// slices read from device memory (the resident kernel) or staged through
// shared memory (Staged: the streaming twin).
//
// rollout.cu and rollout_stream.cu instantiate them for linear dynamics and
// the pendulum, and rollout_nn_l<L>.cu for the MLPs of nn_archs.cuh (one
// file per lane count, so that nvcc builds them side by side), at the lane
// counts of DMPC_LANES (lanes.cuh); variants/rollout.cu instantiates any
// other shape or MLP at first use. An env whose parameters are shared by
// every scenario and fit in shared memory (SharedParams, the MLP's) has them
// copied there once per block before any group starts its scenario; the
// pendulum reads its three, or its per-scenario row, from device memory.
#pragma once

#include <cuda_runtime.h>

#include "nn_mlp.cuh"
#include "rollout.cuh"

namespace rollout_launch_detail {

// Threads per block: fewer where each group stages its slices, so that a
// block's staging rings (rollout_stages slices a group) leave room for
// several blocks on an SM.
template <bool Staged>
constexpr int kThreadsOf = Staged ? 64 : 128;

template <int N, int M, class Env, bool Staged, int L>
__global__ void __launch_bounds__(kThreadsOf<Staged>) rollout_kernel(RolloutArgs a, Env env) {
  constexpr int P = SharedParams<Env>::count;
  extern __shared__ float rollout_slots[];
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int b = (int)(tid / L);
  const CardLanes<L> g = card_lanes<L>(rollout_slots, kThreadsOf<Staged>);
  if constexpr (P > 0) {
    __shared__ float params[P];
    for (int i = threadIdx.x; i < P; i += blockDim.x) params[i] = a.params[i];
    __syncthreads();
    if (b >= a.B) return;  // the whole group: its lanes share b
    linesearch_rollout_scenario<N, M, Staged>(a, env, b, params, g);
  } else {
    if (b >= a.B) return;
    linesearch_rollout_scenario<N, M, Staged>(a, env, b, a.params, g);
  }
}

// Launch the kernel for Env at L lanes; returns cudaGetLastError(), or
// cudaErrorInvalidValue for lanes' trajectory scratch that its groups would
// not use, or lack.
template <int N, int M, class Env, bool Staged, int L>
int launch(const RolloutArgs* args, const Env& env, cudaStream_t stream) {
  if (!rollout_lane_scratch_ok<L>(*args)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kThreads = kThreadsOf<Staged>;
  const long n_threads = (long)args->B * L;
  const int blocks = (int)((n_threads + kThreads - 1) / kThreads);
  const size_t smem = Staged ? sizeof(float) * (kThreads / L) * rollout_group_slot_floats<N, M, Env, L>() : 0;
  if (smem + sizeof(float) * SharedParams<Env>::count > 48 * 1024) {  // the rings beside an MLP's weights
    const cudaError_t err = cudaFuncSetAttribute(rollout_kernel<N, M, Env, Staged, L>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (blocks > 0) rollout_kernel<N, M, Env, Staged, L><<<blocks, kThreads, smem, stream>>>(*args, env);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rollout_launch_detail

// Declare the launches of Env's kernels at L lanes, resident and staged, as
// built in another file, or build them in this one.
#define DMPC_ROLLOUT_EXTERN(Env, L)                                                                       \
  extern template int rollout_launch_detail::launch<Env::N, Env::M, Env, false, L>(const RolloutArgs*,    \
                                                                                    const Env&, cudaStream_t); \
  extern template int rollout_launch_detail::launch<Env::N, Env::M, Env, true, L>(const RolloutArgs*,     \
                                                                                   const Env&, cudaStream_t);
#define DMPC_ROLLOUT_INSTANTIATE(Env, L)                                                                   \
  template int rollout_launch_detail::launch<Env::N, Env::M, Env, false, L>(const RolloutArgs*, const Env&, \
                                                                             cudaStream_t);                 \
  template int rollout_launch_detail::launch<Env::N, Env::M, Env, true, L>(const RolloutArgs*, const Env&,  \
                                                                            cudaStream_t);

// Launch the line search on `stream` with args->lanes threads per scenario;
// returns cudaGetLastError(), or cudaErrorInvalidValue for a lane count that
// is not instantiated (DMPC_LANES) or lanes' trajectory scratch that its
// groups would not use, or lack.
template <int N, int M, bool Staged, class Env>
int rollout_launch(const RolloutArgs* args, const Env& env, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (args->lanes) {
#define DMPC_ROLLOUT_LANE_CASE(_, L_) \
  case L_:                            \
    return rollout_launch_detail::launch<N, M, Env, Staged, L_>(args, env, s);
    DMPC_LANES(DMPC_ROLLOUT_LANE_CASE, _)
#undef DMPC_ROLLOUT_LANE_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
