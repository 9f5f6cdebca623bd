// Streaming twin of the Riccati backward sweep on the card: one thread per
// scenario, each step's inputs double-buffered through shared memory.
//
// Replaces the Pallas TPU kernel riccati_backward_pallas_stream
// (diffmpc_tpu/ops/pallas/riccati_stream.py:171, pallas_call at :263; body
// :43-168), which the JAX package takes over the resident sweep when the
// horizon outgrows VMEM. Each thread runs riccati_stream_scenario
// (riccati_stream.cuh): the value carry in registers, step t-1's slice copied
// by cp.async into one shared-memory slot while step t computes from the
// other, the gains written straight to device memory, batch-minor.
//
// What bounds it on an H100: the same bytes as the resident kernel (each
// input read once, each output written once: ~250 B per scenario-step at
// n = 4, m = 2, box mode), so at large B memory bandwidth; at small B the
// latency of T dependent steps, where the prefetch takes each step's load
// latency off the chain. Shared memory: 2 slots x 59 floats x 64 threads
// (30 KB) at n = 4, m = 2, box mode, so several blocks fit on an SM.
//
// Built by diffmpc_tpu_torch/csrc/build.py with nvcc for sm_90a, without
// --use_fast_math, and bound through the plain-C launchers below with ctypes.

#include <cuda_runtime.h>

#include "riccati_stream.cuh"

extern __shared__ float riccati_stream_smem[];

namespace {

constexpr int kThreads = 64;

template <int N, int M, int MODE>
__global__ void __launch_bounds__(kThreads) riccati_stream_kernel(RiccatiArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;  // no barrier below: each thread streams its own scenario
  riccati_stream_scenario<N, M, MODE>(a, b, riccati_stream_smem + threadIdx.x, blockDim.x);
}

template <int N, int M, int MODE>
int launch_mode(const RiccatiArgs* args, cudaStream_t s) {
  const int blocks = (args->B + kThreads - 1) / kThreads;
  const size_t smem = 2 * RiccatiSlice<N, M, MODE>::kSize * kThreads * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(riccati_stream_kernel<N, M, MODE>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (blocks > 0) riccati_stream_kernel<N, M, MODE><<<blocks, kThreads, smem, s>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int M>
int launch(const RiccatiArgs* args, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kRiccatiBox) return launch_mode<N, M, kRiccatiBox>(args, s);
  if (mode == kRiccatiMask) return launch_mode<N, M, kRiccatiMask>(args, s);
  if (mode == kRiccatiFree) return launch_mode<N, M, kRiccatiFree>(args, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// One launcher per (n, m) of the port's table (ops/cuda/ilqr.py,
// KERNEL_SHAPES); `mode` is a RiccatiMode. Each launches on `stream` and
// returns cudaGetLastError().
extern "C" int diffmpc_riccati_stream_n3m1(const RiccatiArgs* a, int mode, void* s) { return launch<3, 1>(a, mode, s); }
extern "C" int diffmpc_riccati_stream_n3m2(const RiccatiArgs* a, int mode, void* s) { return launch<3, 2>(a, mode, s); }
extern "C" int diffmpc_riccati_stream_n4m1(const RiccatiArgs* a, int mode, void* s) { return launch<4, 1>(a, mode, s); }
extern "C" int diffmpc_riccati_stream_n4m2(const RiccatiArgs* a, int mode, void* s) { return launch<4, 2>(a, mode, s); }
