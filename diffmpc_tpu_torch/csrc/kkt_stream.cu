// Streaming twin of the fused KKT backward on the card: one thread per
// scenario, each sweep's per-step inputs double-buffered through shared
// memory.
//
// Replaces the Pallas TPU kernel kkt_backward_fused_stream
// (diffmpc_tpu/ops/pallas/kkt_stream.py:203, pallas_call at :273; body
// :49-200), which the JAX package takes when the horizon outgrows VMEM. Each
// thread runs kkt_stream_scenario (kkt_stream.cuh): three sweeps, each
// streaming its own slices by cp.async into one slot while the step before
// computes from the other; K, k and p staged in device memory between the
// sweeps; the value carry and the multipliers in registers.
//
// What bounds it on an H100: the bytes it must move (inputs once, outputs
// once: ~280 B per scenario-step at n = 3, m = 1, ~500 B at n = 4, m = 2) at
// large B; it also writes and reads back K, k, p. At small B the latency of
// 3 T dependent steps. Shared memory: 2 slots x 68 floats x 64 threads
// (35 KB) at n = 4, m = 2.
//
// Built by diffmpc_tpu_torch/csrc/build.py with nvcc for sm_90a, without
// --use_fast_math, and bound through the plain-C launchers below with ctypes.

#include <cuda_runtime.h>

#include "kkt_stream.cuh"

extern __shared__ float kkt_stream_smem[];

namespace {

constexpr int kThreads = 64;

template <int N, int M>
__global__ void __launch_bounds__(kThreads) kkt_stream_kernel(KktArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;  // no barrier below: each thread streams its own scenario
  kkt_stream_scenario<N, M>(a, b, kkt_stream_smem + threadIdx.x, blockDim.x);
}

template <int N, int M>
int launch(const KktArgs* args, void* stream) {
  const int blocks = (args->B + kThreads - 1) / kThreads;
  const size_t smem = 2 * KktSlotSize<N, M>::value * kThreads * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kkt_stream_kernel<N, M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (blocks > 0) kkt_stream_kernel<N, M><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launcher per (n, m) of the port's table (ops/cuda/ilqr.py,
// KERNEL_SHAPES). Each launches on `stream` and returns cudaGetLastError().
extern "C" int diffmpc_kkt_backward_stream_n3m1(const KktArgs* a, void* s) { return launch<3, 1>(a, s); }
extern "C" int diffmpc_kkt_backward_stream_n3m2(const KktArgs* a, void* s) { return launch<3, 2>(a, s); }
extern "C" int diffmpc_kkt_backward_stream_n4m1(const KktArgs* a, void* s) { return launch<4, 1>(a, s); }
extern "C" int diffmpc_kkt_backward_stream_n4m2(const KktArgs* a, void* s) { return launch<4, 2>(a, s); }
