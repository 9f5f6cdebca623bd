// Streaming twin of the alpha-ladder line search on the card: a group of L
// threads per scenario, each step's slice staged once for the group.
//
// Replaces the Pallas TPU kernel linesearch_rollout_pallas_stream
// (diffmpc_tpu/ops/pallas/rollout_stream.py:196, pallas_call at :314; body
// :35-193), which streams the horizon through VMEM for horizons too long to
// hold. Each group of L threads runs linesearch_rollout_scenario
// (rollout.cuh) with Staged: the resident kernel's lane-group ladder (the
// whole ladder in one pass, ceil(10 / L) candidates a lane; an MLP's step a
// round of L a pass, one a lane; the baseline riding the first pass, the
// pick a ballot, each lane's first candidate's trajectory kept), where each
// step's slice is copied once for the group into shared memory by
// cp.async, entries split over the lanes, two steps ahead of the step the
// group computes, and read back as a broadcast. A group whose lanes' first
// candidates hold the pick reads the horizon once (the TPU kernel's two
// passes, every ladder state in one and the chosen step's replay, read it
// twice).
//
// What bounds it on an H100: the bytes it must move (each input read once,
// ~330 B per scenario-step at n = 4, m = 2, linear with a box) at large B;
// at small B the chain of one rollout's T dependent steps and the pick.
// Shared memory: a ring of rollout_stages slices for each of a block's
// 64 / L groups (3 x 90 floats x 64 = 69 KB at one lane, n = 4, m = 2,
// linear; 46 KB at two and four, 23 KB at sixteen; above 48 KB the launcher
// raises the block's limit).
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
#define DMPC_ROLLOUT_STREAM_NN_EXTERN(N_, M_, NAME, ...) DMPC_LANES(DMPC_ROLLOUT_EXTERN, NNEnv_##NAME)
DMPC_NN_ARCHS(DMPC_ROLLOUT_STREAM_NN_EXTERN)

// Linear dynamics, one launcher per (n, m) of the port's table
// (ops/cuda/ilqr.py, KERNEL_SHAPES); the pendulum's own step; and the MLP's,
// one per architecture of nn_archs.cuh. Each launches on `stream` with
// args->lanes threads per scenario and returns cudaGetLastError(), or
// cudaErrorInvalidValue (rollout_launch).
extern "C" int diffmpc_rollout_stream_n3m1(const RolloutArgs* a, void* s) { return rollout_launch<3, 1, true>(a, LinearEnv{}, s); }
extern "C" int diffmpc_rollout_stream_n3m2(const RolloutArgs* a, void* s) { return rollout_launch<3, 2, true>(a, LinearEnv{}, s); }
extern "C" int diffmpc_rollout_stream_n4m1(const RolloutArgs* a, void* s) { return rollout_launch<4, 1, true>(a, LinearEnv{}, s); }
extern "C" int diffmpc_rollout_stream_n4m2(const RolloutArgs* a, void* s) { return rollout_launch<4, 2, true>(a, LinearEnv{}, s); }

extern "C" int diffmpc_rollout_stream_pendulum(const RolloutArgs* a, const PendulumEnv* env, void* s) {
  return rollout_launch<PendulumEnv::N, PendulumEnv::M, true>(a, *env, s);
}

// the staged kernels of linear dynamics and the pendulum at every lane count,
// which the resident kernel's launchers (rollout.cu) take too
#define DMPC_ROLLOUT_STAGED_INSTANTIATE(N_, M_, L) \
  template int rollout_launch_detail::launch<N_, M_, LinearEnv, true, L>(const RolloutArgs*, const LinearEnv&, cudaStream_t);
#define DMPC_ROLLOUT_CHEAP_INSTANTIATE(_, L)                                                              \
  DMPC_ROLLOUT_STAGED_INSTANTIATE(3, 1, L) DMPC_ROLLOUT_STAGED_INSTANTIATE(3, 2, L)                       \
  DMPC_ROLLOUT_STAGED_INSTANTIATE(4, 1, L) DMPC_ROLLOUT_STAGED_INSTANTIATE(4, 2, L)                       \
  template int rollout_launch_detail::launch<3, 1, PendulumEnv, true, L>(const RolloutArgs*, const PendulumEnv&, \
                                                                          cudaStream_t);
DMPC_LANES(DMPC_ROLLOUT_CHEAP_INSTANTIATE, _)

#define DMPC_ROLLOUT_STREAM_NN(N_, M_, NAME, ...)                                                        \
  extern "C" int diffmpc_rollout_stream_nn_##NAME(const RolloutArgs* a, const NNEnv_##NAME* env, void* s) { \
    return rollout_launch<N_, M_, true>(a, *env, s);                                                     \
  }

DMPC_NN_ARCHS(DMPC_ROLLOUT_STREAM_NN)
