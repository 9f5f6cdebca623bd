// The piece-decomposition kernels of the fused iLQR sweep on the card: the
// sweep and the rollout by lane groups.
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
// L are built in riccati_pieces_l<L>.cu. The rollout runs on the same lane
// groups and the same ring, walking forward in t: every lane runs the whole
// chain in lockstep, as the line search's lanes replay the accepted step
// (rollout.cuh), so that staging takes each step's 26 loads off the chain
// (one thread per scenario, as before, put B = 1024 on 8 of the 132 SMs and
// each step's loads inside the chain).
//
// What bounds them on an H100: per scenario, step and rep the sweep reads C,
// c, x_hat, u_hat, lo, hi (26 floats) and writes K, k (4), but the reps
// re-read the same data, so the function must move T (26 + 4) floats per
// scenario once: at B = 65,536 about 0.05 ms. Its time is its chain: reps x T
// dependent steps of about 15 (Jacobian) + 12 (sweep) operations, the value
// carry's dependence, and, reading device memory, the latency of each step's
// loads on that chain; the staged mode takes the loads off it. The variants
// take pieces off the chain, and what a piece costs is the full slope less
// the variant's. The rollout reads the same 26 floats a step and writes one
// float per scenario (at B = 1024 and T = 20, 0.00064 ms by bytes); its chain
// is T dependent steps of about 15 operations (~30 ns a step).
//
// Built by diffmpc_tpu_torch/csrc/build.py with nvcc for sm_90a, without
// --use_fast_math, and bound through the plain-C launchers below with ctypes.

#include <cuda_runtime.h>

#include "riccati_pieces_launch.cuh"

DMPC_LANES(DMPC_PIECES_EXTERN, _)

// The sweep kernel in `variant` (a PieceVariant) and the rollout kernel, at
// a->lanes lanes, staged or not as a->staged says. Each launches on `stream`
// and returns cudaGetLastError(), or cudaErrorInvalidValue for a lane count
// that is not built or an unknown variant.
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->lanes) {
#define DMPC_PIECES_LANE_CASE(_, L_) \
  case L_:                           \
    return pieces_launch_detail::rollout_launch<L_>(a, env, s);
    DMPC_LANES(DMPC_PIECES_LANE_CASE, _)
#undef DMPC_PIECES_LANE_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
