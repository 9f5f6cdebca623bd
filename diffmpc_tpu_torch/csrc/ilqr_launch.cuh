// The fused iLQR kernel and its launch, for any env: one thread per scenario.
//
// ilqr.cu (the pendulum) and ilqr_nn.cu (the MLPs of nn_archs.cuh) each
// instantiate it for their envs, with and without the HoistLin pre-pass. An
// env whose parameters are shared by every scenario and fit in shared
// memory (SharedParams, the MLP's) has them copied there once per block
// before any thread starts its scenario; the pendulum reads its three, or
// its per-scenario row, from device memory as before.
#pragma once

#include <cuda_runtime.h>

#include "ilqr.cuh"
#include "nn_mlp.cuh"

namespace ilqr_launch_detail {

constexpr int kThreads = 128;

template <class Env, bool HoistLin>
__global__ void __launch_bounds__(kThreads) ilqr_kernel(IlqrArgs a, Env env) {
  constexpr int P = SharedParams<Env>::count;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (P > 0) {
    __shared__ float params[P];
    for (int i = threadIdx.x; i < P; i += blockDim.x) params[i] = a.params[i];
    __syncthreads();
    if (b >= a.B) return;
    ilqr_solve_scenario<Env::N, Env::M, HoistLin>(a, env, b, params);
  } else {
    if (b >= a.B) return;
    ilqr_solve_scenario<Env::N, Env::M, HoistLin>(a, env, b);
  }
}

}  // namespace ilqr_launch_detail

// Launch the solve on `stream`; returns cudaGetLastError().
template <class Env, bool HoistLin>
int ilqr_launch(const IlqrArgs* args, const Env* env, void* stream) {
  using namespace ilqr_launch_detail;
  const int blocks = (args->B + kThreads - 1) / kThreads;
  if (blocks > 0) {
    ilqr_kernel<Env, HoistLin><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args, *env);
  }
  return static_cast<int>(cudaGetLastError());
}
