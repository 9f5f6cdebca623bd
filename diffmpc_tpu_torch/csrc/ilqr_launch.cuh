// The fused iLQR kernel and its launch, for any env: a group of L threads
// per scenario (ilqr.cuh), L a template argument.
//
// ilqr.cu (the pendulum) and ilqr_nn_l<L>.cu (the MLPs of nn_archs.cuh, one
// file per lane count, so that nvcc builds them side by side; ilqr_nn.cu
// holds their launchers) instantiate it for their envs, with and without the
// HoistLin pre-pass, at the lane counts of DMPC_LANES (lanes.cuh), with the
// default box QP and value update; variants/ilqr.cu instantiates any other
// MLP, enumeration mode (ENUM) or value update (EXACT) at first use. An env whose
// parameters are shared by every scenario and fit in shared memory
// (SharedParams, the MLP's) has them copied there once per block before any
// group starts its scenario; the pendulum reads its three, or its
// per-scenario row, from device memory.
// With L > 1 each group also stages its rollouts' step slices in its own
// column of the block's dynamic shared memory.
#pragma once

#include <cuda_runtime.h>

#include "ilqr.cuh"
#include "nn_mlp.cuh"

namespace ilqr_launch_detail {

constexpr int kThreads = 128;

template <class Env, bool HoistLin, int L, int ENUM, bool EXACT, bool Shared>
__global__ void __launch_bounds__(kThreads) ilqr_kernel(IlqrArgs a, Env env) {
  constexpr int P = SharedParams<Env>::count;
  extern __shared__ float ilqr_slots[];
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int b = (int)(tid / L);
  const CardLanes<L> g = card_lanes<L>(ilqr_slots, kThreads);
  if constexpr (P > 0) {
    __shared__ float params[P];
    for (int i = threadIdx.x; i < P; i += blockDim.x) params[i] = a.params[i];
    __syncthreads();
    if (b >= a.B) return;  // the whole group: its lanes share b
    ilqr_solve_scenario<Env::N, Env::M, HoistLin, ENUM, EXACT, Shared>(a, env, b, params, g);
  } else {
    if (b >= a.B) return;
    ilqr_solve_scenario<Env::N, Env::M, HoistLin, ENUM, EXACT, Shared>(a, env, b, g);
  }
}

// The kernel's HoistLin: a shared sweep that shares its steps out reads no
// pre-pass (its rounds linearize), so its launches with and without
// HoistLin take one kernel, compiled once.
template <bool HoistLin, int L, bool Shared>
constexpr bool kernel_hoist() {
  return HoistLin && !(Shared && L >= kSweepShareLanes);
}

// The dynamic shared memory of a block of Env's kernel at L lanes: each
// group's (ilqr_group_floats)
template <class Env, int L, int ENUM, bool Shared>
constexpr size_t block_smem() {
  return L > 1 ? sizeof(float) * (kThreads / L) * ilqr_group_floats<Env::N, Env::M, Shared, L, ENUM>() : 0;
}

// Above 48 KB of shared memory a block must ask for it: (6, 3) at two and
// four lanes, 64 / 32 groups' rings of 378 floats, beside an MLP's weights,
// and a shared sweep's rounds at 16 lanes where n + m >= 8.
template <class Env, bool HoistLin, int L, int ENUM, bool EXACT, bool Shared>
cudaError_t allow_smem() {
  constexpr size_t smem = block_smem<Env, L, ENUM, Shared>();
  if (smem + sizeof(float) * SharedParams<Env>::count <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(ilqr_kernel<Env, kernel_hoist<HoistLin, L, Shared>(), L, ENUM, EXACT, Shared>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Launch the kernel for Env at L lanes, the box QP's enumeration mode ENUM,
// the value update's form EXACT and the sweep (Shared: riccati_sweep_shared,
// else riccati_sweep; ilqr.cuh); returns cudaGetLastError().
template <class Env, bool HoistLin, int L, int ENUM = kPnqpEnumDefault, bool EXACT = false, bool Shared = false>
int launch(const IlqrArgs* args, const Env* env, cudaStream_t stream) {
  if (!ilqr_lane_scratch_ok<Env, L>(*args)) return static_cast<int>(cudaErrorInvalidValue);
  const long threads = (long)args->B * L;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  const cudaError_t err = allow_smem<Env, HoistLin, L, ENUM, EXACT, Shared>();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks > 0)
    ilqr_kernel<Env, kernel_hoist<HoistLin, L, Shared>(), L, ENUM, EXACT, Shared>
        <<<blocks, kThreads, block_smem<Env, L, ENUM, Shared>(), stream>>>(*args, *env);
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of the kernel for Env at L lanes: out = {registers a
// thread, local memory a thread in bytes (spills and stack), shared memory
// a block in bytes (static and dynamic), blocks an SM holds at once}.
// Returns a cudaError_t.
template <class Env, bool HoistLin, int L, int ENUM = kPnqpEnumDefault, bool EXACT = false, bool Shared = false>
int occupancy(int* out) {
  const auto kernel = ilqr_kernel<Env, kernel_hoist<HoistLin, L, Shared>(), L, ENUM, EXACT, Shared>;
  constexpr size_t smem = block_smem<Env, L, ENUM, Shared>();
  cudaError_t err = allow_smem<Env, HoistLin, L, ENUM, EXACT, Shared>();
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)(attr.sharedSizeBytes + smem);
  out[3] = blocks;
  return 0;
}

}  // namespace ilqr_launch_detail

// Declare the launches of Env's kernels at L lanes, with and without
// HoistLin, as built in another file, or build them in this one.
#define DMPC_ILQR_EXTERN(Env, L)                                                                           \
  extern template int ilqr_launch_detail::launch<Env, false, L>(const IlqrArgs*, const Env*, cudaStream_t); \
  extern template int ilqr_launch_detail::launch<Env, true, L>(const IlqrArgs*, const Env*, cudaStream_t);
#define DMPC_ILQR_INSTANTIATE(Env, L)                                                               \
  template int ilqr_launch_detail::launch<Env, false, L>(const IlqrArgs*, const Env*, cudaStream_t); \
  template int ilqr_launch_detail::launch<Env, true, L>(const IlqrArgs*, const Env*, cudaStream_t);

// Launch the solve on `stream` with args->lanes threads per scenario;
// returns cudaGetLastError(), or cudaErrorInvalidValue for a lane count that
// is not instantiated (DMPC_LANES, lanes.cuh) or lanes' trajectory
// scratch that its groups would not use, or lack.
template <class Env, bool HoistLin, int ENUM = kPnqpEnumDefault, bool EXACT = false, bool Shared = false>
int ilqr_launch(const IlqrArgs* args, const Env* env, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (args->lanes) {
#define DMPC_ILQR_LANE_CASE(_, L_) \
  case L_:                         \
    return ilqr_launch_detail::launch<Env, HoistLin, L_, ENUM, EXACT, Shared>(args, env, s);
    DMPC_LANES(DMPC_ILQR_LANE_CASE, _)
#undef DMPC_ILQR_LANE_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// occupancy() of the kernel at `lanes` lanes; cudaErrorInvalidValue for a
// lane count that is not instantiated.
template <class Env, bool HoistLin, int ENUM = kPnqpEnumDefault, bool EXACT = false, bool Shared = false>
int ilqr_occupancy(int lanes, int* out) {
  switch (lanes) {
#define DMPC_ILQR_OCC_CASE(_, L_) \
  case L_:                        \
    return ilqr_launch_detail::occupancy<Env, HoistLin, L_, ENUM, EXACT, Shared>(out);
    DMPC_LANES(DMPC_ILQR_OCC_CASE, _)
#undef DMPC_ILQR_OCC_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
