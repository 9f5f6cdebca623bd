// The depth-blocked Riccati kernel and its launch (riccati_blocked.cuh), one
// thread per scenario, for (N, M); the block D comes in the args.
//
// riccati_blocked.cu launches it for the port's table of (n, m)
// (ops/cuda/ilqr.py, KERNEL_SHAPES); every other shape is a variant built at
// first use (csrc/variants/riccati_blocked.cu).
#pragma once

#include <cuda_runtime.h>

#include "riccati_blocked.cuh"

namespace riccati_blocked_detail {

constexpr int kThreads = 128;

template <int N, int M, int D>
__global__ void __launch_bounds__(kThreads) riccati_blocked_kernel(RiccatiBlockedArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.ric.B) return;
  riccati_blocked_scenario<N, M, D>(a, b);
}

}  // namespace riccati_blocked_detail

// Launch on `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue
// for a block other than 2 or 4.
template <int N, int M>
int riccati_blocked_launch(const RiccatiBlockedArgs* args, void* stream) {
  using namespace riccati_blocked_detail;
  const int blocks = (args->ric.B + kThreads - 1) / kThreads;
  if (args->block != 2 && args->block != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (args->block == 2) {
      riccati_blocked_kernel<N, M, 2><<<blocks, kThreads, 0, s>>>(*args);
    } else {
      riccati_blocked_kernel<N, M, 4><<<blocks, kThreads, 0, s>>>(*args);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
