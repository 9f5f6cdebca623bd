// Riccati backward sweep on the card: one thread per scenario.
//
// Replaces the Pallas TPU kernel riccati_backward_pallas
// (diffmpc_tpu/ops/pallas/riccati.py:696, pallas_call at :785; body
// :521-613), which runs the sweep t = T-1..0 for a tile of scenarios with
// the horizon in VMEM. Here each thread runs riccati_backward_scenario
// (riccati.cuh) for its own scenario: the value carry and the per-step
// Q, q, the box QP and the gains stay in registers, the horizon arrays are
// read and the gains written batch-minor, so a warp's accesses coalesce.
// Nothing depends on a fast-memory budget, so any T runs here.
//
// What bounds it on an H100: per scenario and step it reads C, c, F (and f,
// lo, hi or the mask) once and writes K, k, free (and n_qp) once, about
// 330 B at n = 4, m = 2, box mode, for a few hundred flops (a few thousand
// with the m = 2 enumeration's nine candidate solves), so at large B it is
// bound by memory bandwidth, and at small B (B = 128 is one block) by the
// latency of one scenario's T dependent steps.
//
// Built by diffmpc_tpu_torch/csrc/build.py with nvcc for sm_90a, without
// --use_fast_math, and bound through the plain-C launchers below with ctypes.

#include <cuda_runtime.h>

#include "riccati.cuh"

namespace {

constexpr int kThreads = 128;

template <int N, int M, int MODE>
__global__ void __launch_bounds__(kThreads) riccati_kernel(RiccatiArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  riccati_backward_scenario<N, M, MODE>(a, b);
}

template <int N, int M>
int launch(const RiccatiArgs* args, int mode, void* stream) {
  const int blocks = (args->B + kThreads - 1) / kThreads;
  if (blocks > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (mode == kRiccatiBox) {
      riccati_kernel<N, M, kRiccatiBox><<<blocks, kThreads, 0, s>>>(*args);
    } else if (mode == kRiccatiMask) {
      riccati_kernel<N, M, kRiccatiMask><<<blocks, kThreads, 0, s>>>(*args);
    } else if (mode == kRiccatiFree) {
      riccati_kernel<N, M, kRiccatiFree><<<blocks, kThreads, 0, s>>>(*args);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launcher per (n, m) of the port's table (ops/cuda/riccati.py); `mode`
// is a RiccatiMode. Each launches on `stream` and returns cudaGetLastError().
extern "C" int diffmpc_riccati_n3m1(const RiccatiArgs* a, int mode, void* s) { return launch<3, 1>(a, mode, s); }
extern "C" int diffmpc_riccati_n3m2(const RiccatiArgs* a, int mode, void* s) { return launch<3, 2>(a, mode, s); }
extern "C" int diffmpc_riccati_n4m1(const RiccatiArgs* a, int mode, void* s) { return launch<4, 1>(a, mode, s); }
extern "C" int diffmpc_riccati_n4m2(const RiccatiArgs* a, int mode, void* s) { return launch<4, 2>(a, mode, s); }
