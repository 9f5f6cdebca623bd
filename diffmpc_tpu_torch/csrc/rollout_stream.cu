// Streaming twin of the alpha-ladder line search on the card: one thread per
// scenario, every ladder rollout in one pass over the horizon.
//
// Replaces the Pallas TPU kernel linesearch_rollout_pallas_stream
// (diffmpc_tpu/ops/pallas/rollout_stream.py:196, pallas_call at :314; body
// :35-193). Each thread runs linesearch_rollout_stream_scenario
// (rollout_stream.cuh): pass 1 streams each step's slice once through
// double-buffered shared memory and advances all ladder states (registers)
// and the baseline; pass 2 streams the horizon again and replays the chosen
// step. The horizon is read twice, where the resident kernel (rollout.cu)
// reads it n_alpha + 2 times.
//
// What bounds it on an H100: the bytes it must move (each input read once,
// ~330 B per scenario-step at n = 4, m = 2, linear with a box) at large B;
// it reads them twice. At small B the chain of one scenario: two passes of T
// dependent steps, the ladder's ten rollouts independent of each other within
// a step. Shared memory: 2 slots x 90 floats x 64 threads (46 KB) at
// n = 4, m = 2, linear; above 48 KB the launcher raises the block's limit.
//
// The MLP step of a kernel-fusable NNDynamics (nn_mlp.cuh) rides the same
// kernel, its weights staged once per block in shared memory.
//
// Built by diffmpc_tpu_torch/csrc/build.py with nvcc for sm_90a, without
// --use_fast_math (the env steps' sinf/cosf/sqrtf/tanhf must stay accurate),
// and bound through the plain-C launchers below with ctypes.

#include <cuda_runtime.h>

#include "nn_archs.cuh"
#include "pendulum.cuh"
#include "rollout_stream.cuh"

extern __shared__ float rollout_stream_smem[];

namespace {

constexpr int kThreads = 64;

// An env whose parameters fit in shared memory (SharedParams, the MLP's) has
// them copied there once per block first, beside the slots; the others read
// device memory, and their threads need no barrier: each streams its own
// scenario.
template <int N, int M, class Env>
__global__ void __launch_bounds__(kThreads) rollout_stream_kernel(RolloutArgs a, Env env) {
  constexpr int P = SharedParams<Env>::count;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (P > 0) {
    __shared__ float params[P];
    for (int i = threadIdx.x; i < P; i += blockDim.x) params[i] = a.params[i];
    __syncthreads();
    if (b >= a.B) return;
    linesearch_rollout_stream_scenario<N, M>(a, env, b, rollout_stream_smem + threadIdx.x, blockDim.x, params);
  } else {
    if (b >= a.B) return;
    linesearch_rollout_stream_scenario<N, M>(a, env, b, rollout_stream_smem + threadIdx.x, blockDim.x);
  }
}

template <int N, int M, class Env>
int launch(const RolloutArgs* args, const Env& env, void* stream) {
  const int blocks = (args->B + kThreads - 1) / kThreads;
  const size_t smem = 2 * RolloutSlice<N, M, Env>::kSize * kThreads * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(rollout_stream_kernel<N, M, Env>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (blocks > 0) {
    rollout_stream_kernel<N, M, Env><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(*args, env);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Linear dynamics, one launcher per (n, m) of the port's table
// (ops/cuda/ilqr.py, KERNEL_SHAPES); the pendulum's own step; and the MLP's,
// one per architecture of nn_archs.cuh. Each launches on `stream` and
// returns cudaGetLastError().
extern "C" int diffmpc_rollout_stream_n3m1(const RolloutArgs* a, void* s) { return launch<3, 1>(a, LinearEnv{}, s); }
extern "C" int diffmpc_rollout_stream_n3m2(const RolloutArgs* a, void* s) { return launch<3, 2>(a, LinearEnv{}, s); }
extern "C" int diffmpc_rollout_stream_n4m1(const RolloutArgs* a, void* s) { return launch<4, 1>(a, LinearEnv{}, s); }
extern "C" int diffmpc_rollout_stream_n4m2(const RolloutArgs* a, void* s) { return launch<4, 2>(a, LinearEnv{}, s); }

extern "C" int diffmpc_rollout_stream_pendulum(const RolloutArgs* a, const PendulumEnv* env, void* s) {
  return launch<PendulumEnv::N, PendulumEnv::M>(a, *env, s);
}

#define DMPC_ROLLOUT_STREAM_NN(N_, M_, NAME, ...)                                              \
  extern "C" int diffmpc_rollout_stream_nn_##NAME(const RolloutArgs* a,                       \
                                                  const NNEnv<N_, M_, __VA_ARGS__>* env, void* s) { \
    return launch<N_, M_>(a, *env, s);                                                         \
  }

DMPC_NN_ARCHS(DMPC_ROLLOUT_STREAM_NN)
