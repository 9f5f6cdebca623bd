// The piece-decomposition kernels of the fused iLQR sweep on the card: the
// sweep by lane groups, the rollout one thread per scenario.
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
// The sweep runs as the fused kernel's sweep (ilqr.cuh, riccati_sweep): a
// group of L lanes per scenario, L in DMPC_LANES (the wrapper takes the
// fused kernel's rule, ops/cuda/ilqr.py ilqr_lanes: 16 lanes at B = 1024,
// 128 blocks, against one thread per scenario's 8), each step's inputs read
// from device memory at the step or staged through the group's ring of
// shared-memory slots ahead of it (riccati_pieces.cuh); the kernels of each
// L are built in riccati_pieces_l<L>.cu.
//
// What bounds them on an H100: per scenario, step and rep the sweep reads C,
// c, x_hat, u_hat, lo, hi (26 floats) and writes K, k (4), but the reps
// re-read the same data, so the function must move T (26 + 4) floats per
// scenario once: at B = 65,536 about 0.05 ms. Its time is its chain: reps x T
// dependent steps of about 15 (Jacobian) + 12 (sweep) operations, the value
// carry's dependence, and, reading device memory, the latency of each step's
// loads on that chain; the staged mode takes the loads off it. The variants
// take pieces off the chain, and what a piece costs is the full slope less
// the variant's.
//
// Built by diffmpc_tpu_torch/csrc/build.py with nvcc for sm_90a, without
// --use_fast_math, and bound through the plain-C launchers below with ctypes.

#include <cuda_runtime.h>

#include "riccati_pieces_launch.cuh"

DMPC_LANES(DMPC_PIECES_EXTERN, _)

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) piece_rollout_kernel(PieceArgs a, PendulumEnv env) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  piece_rollout_scenario(a, env, b);
}

}  // namespace

// The sweep kernel in `variant` (a PieceVariant) at a->lanes lanes, staged
// or not as a->staged says, and the rollout kernel. Each launches on
// `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for a
// lane count that is not built or an unknown variant.
extern "C" int diffmpc_riccati_pieces_sweep(const PieceArgs* a, const PendulumEnv* env, int variant, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->lanes) {
#define DMPC_PIECES_LANE_CASE(_, L_) \
  case L_:                           \
    return pieces_launch_detail::sweep_launch<L_>(a, env, variant, s);
    DMPC_LANES(DMPC_PIECES_LANE_CASE, _)
#undef DMPC_PIECES_LANE_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int diffmpc_riccati_pieces_rollout(const PieceArgs* a, const PendulumEnv* env, void* stream) {
  const int blocks = (a->B + kThreads - 1) / kThreads;
  if (blocks > 0) piece_rollout_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a, *env);
  return static_cast<int>(cudaGetLastError());
}
