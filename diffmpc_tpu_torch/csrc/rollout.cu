// Alpha-ladder line-search rollout on the card: a group of L threads per
// scenario, each step's slice staged once for the group (read from device
// memory by each lane for an MLP's step).
//
// Replaces the Pallas TPU kernel linesearch_rollout_pallas
// (diffmpc_tpu/ops/pallas/rollout.py:180, pallas_call at :301; body
// :45-177), which evaluates the whole ladder for a tile of scenarios with
// the horizon in VMEM. Here each group of L threads runs
// linesearch_rollout_scenario (rollout.cuh) for its own scenario: the whole
// ladder in one pass, ceil(10 / L) candidates a lane (an MLP's step: a round
// of L candidates a pass, one a lane, and no round after the first that
// improves), the baseline cost of (x_hat, u_hat) riding the first pass,
// shared out row by row, the pick a ballot; each lane keeps its first
// candidate's trajectory, and where one of those is chosen it becomes xs,
// us, as does, where none improves, the rollout of alpha_floor by the lane
// past the ladder (or by the ladder's last step where it lands on
// alpha_floor's bits), so only a later improving step, or none without such
// a lane, is replayed. The states, the controls and the running costs live in
// registers; the horizon arrays are read batch-minor, so a warp's copies
// coalesce. For linear dynamics and the pendulum this is the twin's kernel
// (rollout_stream.cu): staging each step's slice for the group beat each
// lane's own loads at every shape the A/B ran (ab_rollout_lanes, PERF.md);
// an MLP's step reads device memory itself, which won on a full card.
//
// What bounds it on an H100: per scenario it must read about 6.2 KB (n = 4,
// m = 2, T = 20, linear dynamics with a box), once a pass: once where a
// lane's first candidate or the lane past the ladder holds the pick's
// trajectory, twice where the replay builds it (one thread per scenario,
// each rollout after the other, reads it
// n_alpha + 2 times whatever the pick). At large B that is the bytes bound;
// at small B the latency of one rollout's T dependent steps and the pick,
// with L times as many threads as scenarios to hide it. Which L a batch
// takes is the wrapper's rule (ops/cuda/rollout.py, rollout_lanes), from
// the card's measurements.
//
// The MLP step of a kernel-fusable NNDynamics (nn_mlp.cuh) rides the same
// kernel, its weights staged once per block in shared memory; its kernels
// are built in rollout_nn_l<L>.cu, one file per lane count.
//
// Built by diffmpc_tpu_torch/csrc/build.py with nvcc for sm_90a, without
// --use_fast_math (the env steps' sinf/cosf/sqrtf/tanhf must stay accurate),
// and bound through the plain-C launchers below with ctypes.

#include "nn_archs.cuh"
#include "pendulum.cuh"
#include "rollout_launch.cuh"

// each architecture's kernels, at every lane count, are built in rollout_nn_l<L>.cu
#define DMPC_ROLLOUT_NN_EXTERN(N_, M_, NAME, ...) DMPC_LANES(DMPC_ROLLOUT_EXTERN, NNEnv_##NAME)
DMPC_NN_ARCHS(DMPC_ROLLOUT_NN_EXTERN)

// the staged kernels of linear dynamics and the pendulum are the twin's,
// built in rollout_stream.cu
#define DMPC_ROLLOUT_STAGED_EXTERN(N_, M_, L)                                                                \
  extern template int rollout_launch_detail::launch<N_, M_, LinearEnv, true, L>(const RolloutArgs*,         \
                                                                                 const LinearEnv&, cudaStream_t);
#define DMPC_ROLLOUT_CHEAP_EXTERN(_, L)                                                                    \
  DMPC_ROLLOUT_STAGED_EXTERN(3, 1, L) DMPC_ROLLOUT_STAGED_EXTERN(3, 2, L) DMPC_ROLLOUT_STAGED_EXTERN(4, 1, L) \
  DMPC_ROLLOUT_STAGED_EXTERN(4, 2, L)                                                                        \
  extern template int rollout_launch_detail::launch<3, 1, PendulumEnv, true, L>(const RolloutArgs*,          \
                                                                                 const PendulumEnv&, cudaStream_t);
DMPC_LANES(DMPC_ROLLOUT_CHEAP_EXTERN, _)

// Linear dynamics, one launcher per (n, m) of the port's table
// (ops/cuda/ilqr.py, KERNEL_SHAPES); the pendulum's own step; and the MLP's,
// one per architecture of nn_archs.cuh. Each launches on `stream` with
// args->lanes threads per scenario and returns cudaGetLastError(), or
// cudaErrorInvalidValue (rollout_launch). Staged but for the MLP's.
extern "C" int diffmpc_rollout_n3m1(const RolloutArgs* a, void* s) { return rollout_launch<3, 1, true>(a, LinearEnv{}, s); }
extern "C" int diffmpc_rollout_n3m2(const RolloutArgs* a, void* s) { return rollout_launch<3, 2, true>(a, LinearEnv{}, s); }
extern "C" int diffmpc_rollout_n4m1(const RolloutArgs* a, void* s) { return rollout_launch<4, 1, true>(a, LinearEnv{}, s); }
extern "C" int diffmpc_rollout_n4m2(const RolloutArgs* a, void* s) { return rollout_launch<4, 2, true>(a, LinearEnv{}, s); }

extern "C" int diffmpc_rollout_pendulum(const RolloutArgs* a, const PendulumEnv* env, void* s) {
  return rollout_launch<PendulumEnv::N, PendulumEnv::M, true>(a, *env, s);
}

#define DMPC_ROLLOUT_NN(N_, M_, NAME, ...)                                                        \
  extern "C" int diffmpc_rollout_nn_##NAME(const RolloutArgs* a, const NNEnv_##NAME* env, void* s) { \
    return rollout_launch<N_, M_, false>(a, *env, s);                                             \
  }

DMPC_NN_ARCHS(DMPC_ROLLOUT_NN)
