// Alpha-ladder line-search rollout on the card: one thread per scenario.
//
// Replaces the Pallas TPU kernel linesearch_rollout_pallas
// (diffmpc_tpu/ops/pallas/rollout.py:180, pallas_call at :301; body
// :45-177), which evaluates the whole ladder for a tile of scenarios with
// the horizon in VMEM. Here each thread runs linesearch_rollout_scenario
// (rollout.cuh) for its own scenario: the baseline cost of (x_hat, u_hat),
// n_alpha rollouts of the ladder and the replay of the chosen one, with the
// state, the controls and the running cost in registers. The horizon arrays
// are read batch-minor, so a warp's loads coalesce; nothing depends on a
// fast-memory budget, so any T runs here.
//
// The MLP step of a kernel-fusable NNDynamics (nn_mlp.cuh) rides the same
// kernel, its weights staged once per block in shared memory.
//
// What bounds it on an H100: per scenario it reads about 7.7 KB once
// (n = 4, m = 2, T = 20, linear dynamics with a box) but n_alpha + 2 times
// over, about 12 times the unique bytes at n_alpha = 10. At large B it is
// bound by memory traffic unless the re-reads of a scenario's horizon hit
// in L1/L2; at small B by the latency of (n_alpha + 2) T dependent steps.
//
// Built by diffmpc_tpu_torch/csrc/build.py with nvcc for sm_90a, without
// --use_fast_math (the env steps' sinf/cosf/sqrtf/tanhf must stay accurate),
// and bound through the plain-C launchers below with ctypes.

#include <cuda_runtime.h>

#include "nn_archs.cuh"
#include "pendulum.cuh"
#include "rollout.cuh"

namespace {

constexpr int kThreads = 128;

// An env whose parameters fit in shared memory (SharedParams, the MLP's) has
// them copied there once per block first; the others read device memory.
template <int N, int M, class Env>
__global__ void __launch_bounds__(kThreads) rollout_kernel(RolloutArgs a, Env env) {
  constexpr int P = SharedParams<Env>::count;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (P > 0) {
    __shared__ float params[P];
    for (int i = threadIdx.x; i < P; i += blockDim.x) params[i] = a.params[i];
    __syncthreads();
    if (b >= a.B) return;
    linesearch_rollout_scenario<N, M>(a, env, b, params);
  } else {
    if (b >= a.B) return;
    linesearch_rollout_scenario<N, M>(a, env, b);
  }
}

template <int N, int M, class Env>
int launch(const RolloutArgs* args, const Env& env, void* stream) {
  const int blocks = (args->B + kThreads - 1) / kThreads;
  if (blocks > 0) {
    rollout_kernel<N, M, Env><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args, env);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Linear dynamics, one launcher per (n, m) of the port's table
// (ops/cuda/ilqr.py, KERNEL_SHAPES); the pendulum's own step; and the MLP's,
// one per architecture of nn_archs.cuh. Each launches on `stream` and
// returns cudaGetLastError().
extern "C" int diffmpc_rollout_n3m1(const RolloutArgs* a, void* s) { return launch<3, 1>(a, LinearEnv{}, s); }
extern "C" int diffmpc_rollout_n3m2(const RolloutArgs* a, void* s) { return launch<3, 2>(a, LinearEnv{}, s); }
extern "C" int diffmpc_rollout_n4m1(const RolloutArgs* a, void* s) { return launch<4, 1>(a, LinearEnv{}, s); }
extern "C" int diffmpc_rollout_n4m2(const RolloutArgs* a, void* s) { return launch<4, 2>(a, LinearEnv{}, s); }

extern "C" int diffmpc_rollout_pendulum(const RolloutArgs* a, const PendulumEnv* env, void* s) {
  return launch<PendulumEnv::N, PendulumEnv::M>(a, *env, s);
}

#define DMPC_ROLLOUT_NN(N_, M_, NAME, ...)                                                               \
  extern "C" int diffmpc_rollout_nn_##NAME(const RolloutArgs* a, const NNEnv<N_, M_, __VA_ARGS__>* env, void* s) { \
    return launch<N_, M_>(a, *env, s);                                                                   \
  }

DMPC_NN_ARCHS(DMPC_ROLLOUT_NN)
