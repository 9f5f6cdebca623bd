// The KKT backward kernels and their launch: a group of L threads per
// scenario (kkt.cuh), L a template argument, K, k and p kept in the group's
// shared memory (OnChip) or in device memory, each step's slice loaded while
// the step before computes (Prefetch) or at its step, for (N, M) and the
// value update's form EXACT.
//
// kkt_l<L>.cu instantiates them for every (n, m) of the port's table at its
// own lane count (one file per lane count, so that nvcc builds them side by
// side) with the full value update; kkt.cu (the resident kernel) and
// kkt_stream.cu (the twin) hold the launchers, which pick the lane count from
// the args. variants/kkt.cu instantiates any other shape, and the
// simplified update, at first use.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

#include "kkt.cuh"

// The lane counts the KKT kernels are built for, X(A, L) for each: one file
// per lane count, kkt_l<L>.cu, and the wrapper's KKT_LANES (the tests hold
// the three equal). Two and four lanes never beat both one and sixteen
// (ops/cuda/kkt.py, kkt_lanes), so the card builds neither; the tests' host
// build runs every DMPC_LANES count.
#define DMPC_KKT_LANES(X, A) X(A, 1) X(A, 16)

namespace kkt_launch_detail {

// Threads per block: 128 at one lane, 64 for a group of lanes (four groups
// of 16). Sixteen lanes at 32, 64 or 128 took within a few per cent of each
// other on the KKT calls of diagnostics/ab_kkt_lanes; one lane at 32 or 64
// took 0.0205 against 0.0215 ms at the pendulum, T=20, B=1024, but 0.215
// against 0.176 at B=65,536 and 0.98-0.99 against 0.94 at T=512, B=1024,
// and at 256 up to 20% longer (NVIDIA H100 80GB HBM3 at 700 W).
template <int L>
constexpr int kThreads = L == 1 ? 128 : 64;

template <int N, int M, bool EXACT, int L, bool OnChip, bool Prefetch>
__global__ void __launch_bounds__(kThreads<L>) kkt_kernel(KktArgs a) {
  extern __shared__ float kkt_slots[];
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int b = (int)(tid / L);
  CardLanes<L> g = card_lanes<L>(kkt_slots, blockDim.x);
  // the groups of a warp synchronise together, so that they stay converged
  if constexpr (L > 1) g.mask = __ballot_sync(0xffffffffu, b < a.B);
  if (b >= a.B) return;  // the whole group: its lanes share b
  kkt_backward_group<N, M, EXACT, OnChip, Prefetch>(a, g, b);
}

template <int N, int M, int L, bool OnChip>
size_t smem_bytes(int T) {
  return sizeof(float) * (size_t)(kThreads<L> / L) * (size_t)kkt_group_floats<N, M, L, OnChip>(T);
}

template <int N, int M, bool EXACT, int L, bool OnChip, bool Prefetch>
int launch(const KktArgs* args, cudaStream_t stream) {
  constexpr int threads = kThreads<L>;
  const size_t smem = smem_bytes<N, M, L, OnChip>(args->T);
  const long n_threads = (long)args->B * L;
  const int blocks = (int)((n_threads + threads - 1) / threads);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kkt_kernel<N, M, EXACT, L, OnChip, Prefetch>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // the refusal is this call's answer, not a later launch's
      return static_cast<int>(err);
    }
  }
  if (blocks > 0) kkt_kernel<N, M, EXACT, L, OnChip, Prefetch><<<blocks, threads, smem, stream>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// Scenarios one wave of the kernel holds on the card over T steps (0 where
// its shared memory does not fit a block).
template <int N, int M, bool EXACT, int L, bool OnChip, bool Prefetch>
long wave(int T, int* err) {
  int dev = 0, max_smem = 0, sms = 0, blocks = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = smem_bytes<N, M, L, OnChip>(T);
  if (e == cudaSuccess && smem > (size_t)max_smem) {
    *err = 0;
    return 0;
  }
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kkt_kernel<N, M, EXACT, L, OnChip, Prefetch>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kkt_kernel<N, M, EXACT, L, OnChip, Prefetch>,
                                                      kThreads<L>, smem);
  *err = static_cast<int>(e);
  return (long)sms * blocks * (kThreads<L> / L);
}

// One wave of the one-lane prefetching kernel: it takes no shared memory,
// so the horizon does not enter, and the wave is worked out once per card.
//
// In an unnamed namespace, so that each library has its own cache: a
// function-local static of an inline function or template is one object
// across every library of the process (GNU unique symbols bind even under
// RTLD_LOCAL), and a second build of this source loaded beside
// (ab_kkt_lanes --parent) would otherwise take the wave of whichever
// library asked first.
namespace {

template <int N, int M, bool EXACT>
long one_lane_wave(int* err) {
  constexpr int kMaxCards = 16;
  static std::atomic<long> cached[kMaxCards];  // 0: not yet known
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  *err = static_cast<int>(e);
  if (e != cudaSuccess) return 0;
  long w = dev < kMaxCards ? cached[dev].load(std::memory_order_relaxed) : 0;
  if (w == 0) {
    w = wave<N, M, EXACT, 1, false, true>(0, err);
    if (*err == 0 && dev < kMaxCards) cached[dev].store(w, std::memory_order_relaxed);
  }
  return w;
}

}  // namespace

// The kernel at L lanes. One lane keeps K, k and p in device memory and
// loads the next step's slice while a step computes as args->prefetch says,
// where a negative value asks for the launcher's choice, written back: while
// one wave of the prefetching kernel holds the batch (it takes more
// registers; on a full card loading each slice at its step wins: config 2 at
// B=65,536, 0.4615 against 0.4936 ms at T=20, 2.948 against 3.188 at T=128,
// where at 16,384 prefetching won, 0.1631 against 0.1700; NVIDIA H100 80GB
// HBM3 at 700 W, diagnostics/ab_kkt_lanes). More lanes always prefetch, and
// keep K, k and p on chip as args->on_chip says, where a negative value asks
// for the launcher's choice, written back: on chip where that leaves an SM
// as many groups as device memory does, or the batch fits the card in one
// wave anyway. The twin keeps them in device memory, as the TPU's streaming
// twin does.
template <int N, int M, int L, bool EXACT = false>
int lanes_launch(KktArgs* args, bool twin, cudaStream_t stream) {
  int err = 0;
  if constexpr (L == 1) {
    args->on_chip = 0;
    if (args->prefetch < 0) {
      const long w = one_lane_wave<N, M, EXACT>(&err);
      if (err != 0) return err;
      args->prefetch = (long)args->B <= w ? 1 : 0;
    }
    if (args->prefetch) return launch<N, M, EXACT, 1, false, true>(args, stream);
    return launch<N, M, EXACT, 1, false, false>(args, stream);
  } else {
    args->prefetch = 1;
    if (twin) {
      args->on_chip = 0;
    } else if (args->on_chip < 0) {
      const long on = wave<N, M, EXACT, L, true, true>(args->T, &err);
      if (err != 0) return err;
      const long off = on > 0 ? wave<N, M, EXACT, L, false, true>(args->T, &err) : 0;
      if (err != 0) return err;
      args->on_chip = on > 0 && (on >= off || (long)args->B <= on) ? 1 : 0;
    }
    if (args->on_chip) return launch<N, M, EXACT, L, true, true>(args, stream);
    return launch<N, M, EXACT, L, false, true>(args, stream);
  }
}

}  // namespace kkt_launch_detail

// The (n, m) of the port's table (ops/cuda/ilqr.py, KERNEL_SHAPES), X(N, M, A)
// for each; every other shape, and the simplified update, is a variant built
// at first use (csrc/variants/kkt.cu).
#define DMPC_KKT_SHAPES(X, A) X(3, 1, A) X(3, 2, A) X(4, 1, A) X(4, 2, A)

// Declare the kernels of (N, M) at L lanes as built in kkt_l<L>.cu, or build
// them there.
#define DMPC_KKT_EXTERN_SHAPE(N_, M_, L) \
  extern template int kkt_launch_detail::lanes_launch<N_, M_, L>(KktArgs*, bool, cudaStream_t);
#define DMPC_KKT_EXTERN(_, L) DMPC_KKT_SHAPES(DMPC_KKT_EXTERN_SHAPE, L)
#define DMPC_KKT_INSTANTIATE_SHAPE(N_, M_, L) \
  template int kkt_launch_detail::lanes_launch<N_, M_, L>(KktArgs*, bool, cudaStream_t);
#define DMPC_KKT_INSTANTIATE(L) DMPC_KKT_SHAPES(DMPC_KKT_INSTANTIATE_SHAPE, L)

// Launch the backward on `stream` with args->lanes threads per scenario, the
// resident kernel or (`twin`) the streaming twin: one kernel, the twin's
// K, k and p in device memory. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a lane count that is not built
// (DMPC_KKT_LANES).
template <int N, int M, bool EXACT = false>
int kkt_launch(KktArgs* args, bool twin, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (args->lanes) {
#define DMPC_KKT_LANE_CASE(_, L_) \
  case L_:                        \
    return kkt_launch_detail::lanes_launch<N, M, L_, EXACT>(args, twin, s);
    DMPC_KKT_LANES(DMPC_KKT_LANE_CASE, _)
#undef DMPC_KKT_LANE_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
