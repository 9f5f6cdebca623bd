// The piece-decomposition kernels of the fused iLQR sweep on the card: one
// thread per scenario.
//
// Replace the Pallas TPU kernels that scripts/profile_riccati_pieces.py
// builds (build, :219, pallas_call at :234): make_sweep_kernel (:52), the
// fused iLQR kernel's Riccati step with one piece stubbed, and
// make_rollout_kernel (:181), a gain-feedback rollout, each repeated `reps`
// times inside one kernel with a seed chain (riccati_pieces.cuh). On the TPU
// the rep count was compiled in, and Mosaic made two different programs of
// reps = 1 and reps = 9, so the slope between them came out negative; here
// reps is a runtime argument of one binary.
//
// What bounds them on an H100: per scenario, step and rep the sweep reads C,
// c, x_hat, u_hat, lo, hi (25 floats) and writes K, k (4), but the reps
// re-read the same data, so the function must move T (25 + 4) floats per
// scenario once: at B = 65,536 about 0.05 ms. Its time is its chain: reps x T
// dependent steps of about 15 (Jacobian) + 12 (sweep) operations, the value
// carry's dependence; at B = 1024 (8 blocks of 128) the card runs 32 warps
// and each warp's chain is the time. The variants take pieces off that
// chain, and what a piece costs is the full slope less the variant's.
//
// Built by diffmpc_tpu_torch/csrc/build.py with nvcc for sm_90a, without
// --use_fast_math, and bound through the plain-C launchers below with ctypes.

#include <cuda_runtime.h>

#include "riccati_pieces.cuh"

namespace {

constexpr int kThreads = 128;

template <int VARIANT>
__global__ void __launch_bounds__(kThreads) piece_sweep_kernel(PieceArgs a, PendulumEnv env) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  piece_sweep_scenario<VARIANT>(a, env, b);
}

__global__ void __launch_bounds__(kThreads) piece_rollout_kernel(PieceArgs a, PendulumEnv env) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  piece_rollout_scenario(a, env, b);
}

}  // namespace

// The sweep kernel in `variant` (a PieceVariant), and the rollout kernel.
// Each launches on `stream` and returns cudaGetLastError().
extern "C" int diffmpc_riccati_pieces_sweep(const PieceArgs* a, const PendulumEnv* env, int variant, void* stream) {
  const int blocks = (a->B + kThreads - 1) / kThreads;
  if (blocks > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (variant) {
      case kPieceFull: piece_sweep_kernel<kPieceFull><<<blocks, kThreads, 0, s>>>(*a, *env); break;
      case kPieceNoLin: piece_sweep_kernel<kPieceNoLin><<<blocks, kThreads, 0, s>>>(*a, *env); break;
      case kPieceNoQform: piece_sweep_kernel<kPieceNoQform><<<blocks, kThreads, 0, s>>>(*a, *env); break;
      case kPieceNoPnqp: piece_sweep_kernel<kPieceNoPnqp><<<blocks, kThreads, 0, s>>>(*a, *env); break;
      case kPieceNoVup: piece_sweep_kernel<kPieceNoVup><<<blocks, kThreads, 0, s>>>(*a, *env); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int diffmpc_riccati_pieces_rollout(const PieceArgs* a, const PendulumEnv* env, void* stream) {
  const int blocks = (a->B + kThreads - 1) / kThreads;
  if (blocks > 0) piece_rollout_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a, *env);
  return static_cast<int>(cudaGetLastError());
}
