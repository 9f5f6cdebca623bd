// The KKT backward kernels and their launch, resident (kkt.cuh) and streaming
// twin (kkt_stream.cuh), one thread per scenario, for (N, M) and the value
// update's form EXACT (kkt_aux_step).
//
// kkt.cu and kkt_stream.cu launch them for the port's table of (n, m)
// (ops/cuda/ilqr.py, KERNEL_SHAPES) with the full value update; every other
// shape, and the simplified update, is a variant built at first use
// (csrc/variants/kkt.cu).
#pragma once

#include <cuda_runtime.h>

#include "kkt.cuh"
#include "kkt_stream.cuh"

extern __shared__ float kkt_stream_smem[];

namespace kkt_launch_detail {

constexpr int kThreads = 128;       // the resident kernel's block
constexpr int kStreamThreads = 64;  // the twin's: two slots a thread in shared memory

template <int N, int M, bool EXACT>
__global__ void __launch_bounds__(kThreads) kkt_kernel(KktArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  kkt_backward_scenario<N, M, EXACT>(a, b);
}

template <int N, int M, bool EXACT>
__global__ void __launch_bounds__(kStreamThreads) kkt_stream_kernel(KktArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;  // no barrier below: each thread streams its own scenario
  kkt_stream_scenario<N, M, EXACT>(a, b, kkt_stream_smem + threadIdx.x, blockDim.x);
}

}  // namespace kkt_launch_detail

// Launch the resident kernel on `stream`; returns cudaGetLastError().
template <int N, int M, bool EXACT = false>
int kkt_launch(const KktArgs* args, void* stream) {
  using namespace kkt_launch_detail;
  const int blocks = (args->B + kThreads - 1) / kThreads;
  if (blocks > 0) kkt_kernel<N, M, EXACT><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// Launch the twin on `stream`; returns cudaGetLastError().
template <int N, int M, bool EXACT = false>
int kkt_stream_launch(const KktArgs* args, void* stream) {
  using namespace kkt_launch_detail;
  const int blocks = (args->B + kStreamThreads - 1) / kStreamThreads;
  const size_t smem = 2 * KktSlotSize<N, M>::value * kStreamThreads * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kkt_stream_kernel<N, M, EXACT>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (blocks > 0)
    kkt_stream_kernel<N, M, EXACT><<<blocks, kStreamThreads, smem, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
