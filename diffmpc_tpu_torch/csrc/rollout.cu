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
// What bounds it on an H100: per scenario it reads about 7.7 KB once
// (n = 4, m = 2, T = 20, linear dynamics with a box) but n_alpha + 2 times
// over, about 12 times the unique bytes at n_alpha = 10. At large B it is
// bound by memory traffic unless the re-reads of a scenario's horizon hit
// in L1/L2; at small B by the latency of (n_alpha + 2) T dependent steps.
//
// Built by diffmpc_tpu_torch/csrc/build.py with nvcc for sm_90a, without
// --use_fast_math (the pendulum step's sinf/cosf/sqrtf must stay accurate),
// and bound through the plain-C launchers below with ctypes.

#include <cuda_runtime.h>

#include "pendulum.cuh"
#include "rollout.cuh"

namespace {

constexpr int kThreads = 128;

template <int N, int M, class Env>
__global__ void __launch_bounds__(kThreads) rollout_kernel(RolloutArgs a, Env env) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  linesearch_rollout_scenario<N, M>(a, env, b);
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
// (ops/cuda/ilqr.py, KERNEL_SHAPES); and the pendulum's own step. Each
// launches on `stream` and returns cudaGetLastError().
extern "C" int diffmpc_rollout_n3m1(const RolloutArgs* a, void* s) { return launch<3, 1>(a, LinearEnv{}, s); }
extern "C" int diffmpc_rollout_n3m2(const RolloutArgs* a, void* s) { return launch<3, 2>(a, LinearEnv{}, s); }
extern "C" int diffmpc_rollout_n4m1(const RolloutArgs* a, void* s) { return launch<4, 1>(a, LinearEnv{}, s); }
extern "C" int diffmpc_rollout_n4m2(const RolloutArgs* a, void* s) { return launch<4, 2>(a, LinearEnv{}, s); }

extern "C" int diffmpc_rollout_pendulum(const RolloutArgs* a, const PendulumEnv* env, void* s) {
  return launch<PendulumEnv::N, PendulumEnv::M>(a, *env, s);
}
