// The Riccati sweep kernels and their launch: a group of L threads per
// scenario (riccati.cuh), L a template argument, the step slices read from
// device memory (Staged false) or staged through shared memory (Staged).
//
// riccati_l<L>.cu instantiates them for every (n, m) of the port's table and
// every mode at its own lane count (one file per lane count, so that nvcc
// builds them side by side), the box QP at its default enumeration mode;
// riccati.cu and riccati_stream.cu hold the launchers, which pick the lane
// count from the args. variants/riccati.cu instantiates any other shape or
// mode (ENUM) at first use.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

#include "riccati.cuh"

// The lane counts the sweep's kernels are built for, X(A, L) for each: one
// file per lane count, riccati_l<L>.cu, and the wrapper's RICCATI_LANES (the
// tests hold the three equal). Two and four lanes never beat both one and
// sixteen (ops/cuda/riccati.py, riccati_lanes), so the card builds neither;
// the tests' host build runs every DMPC_LANES count.
#define DMPC_RICCATI_LANES(X, A) X(A, 1) X(A, 16)

namespace riccati_launch_detail {

// Threads per block: 128 reading device memory (one lane); 64 where each
// group stages its slices, so that a block's staging rings leave room for
// several blocks on an SM. A 16-lane step runs best with few warps an SM:
// 64 threads a block were as fast as 32 and faster than 128, 256 or 512
// (config 2 at T=20, B=128: 0.053 against 0.055, 0.060 and 0.091 ms a call,
// diagnostics/ab_riccati_lanes on an NVIDIA H100 80GB HBM3 at 700 W).
template <bool Staged>
constexpr int kThreadsOf = Staged ? 64 : 128;

template <int N, int M, int MODE, bool Staged, int L, int ENUM>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kThreadsOf<Staged> / L) * riccati_group_floats<N, M, MODE, Staged, L, ENUM>();
}

template <int N, int M, int MODE, bool Staged, int L, int ENUM>
__global__ void __launch_bounds__(kThreadsOf<Staged>) riccati_kernel(RiccatiArgs a) {
  extern __shared__ float riccati_slots[];
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int b = (int)(tid / L);
  CardLanes<L> g = card_lanes<L>(riccati_slots, kThreadsOf<Staged>);
  // the groups of a warp synchronise together, so that they stay converged
  // (the sweep uses the mask for nothing else): config 2 at T=128, B=128,
  // 16 lanes, 0.304 against 0.324 ms a call with each group alone, the
  // pendulum at T=256 0.227 against 0.261
  if constexpr (L > 1) g.mask = __ballot_sync(0xffffffffu, b < a.B);
  if (b >= a.B) return;  // the whole group: its lanes share b
  riccati_sweep<N, M, MODE, Staged, ENUM>(a, g, b);
}

template <int N, int M, int MODE, bool Staged, int L, int ENUM>
int launch(const RiccatiArgs* args, cudaStream_t stream) {
  constexpr int kThreads = kThreadsOf<Staged>;
  constexpr size_t smem = smem_bytes<N, M, MODE, Staged, L, ENUM>();
  const long n_threads = (long)args->B * L;
  const int blocks = (int)((n_threads + kThreads - 1) / kThreads);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(riccati_kernel<N, M, MODE, Staged, L, ENUM>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (blocks > 0) riccati_kernel<N, M, MODE, Staged, L, ENUM><<<blocks, kThreads, smem, stream>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// Whether one lane stages its slices for a batch of B scenarios: while the
// batch fits the card in one wave of the staged kernel's blocks (as many as
// its rings let an SM hold, by the occupancy calculator), past which reading
// device memory wins (config 2 at B=65,536: 0.195 against 0.340 ms a call at
// T=20, 1.121 against 2.066 at T=128; at 16,384 staging wins, 0.110 against
// 0.136 and 0.663 against 0.826; NVIDIA H100 80GB HBM3 at 700 W,
// diagnostics/ab_riccati_lanes). A wave is worked out once per card.
//
// In an unnamed namespace, so that each library has its own cache: a
// function-local static of an inline function or template is one object
// across every library of the process (GNU unique symbols bind even under
// RTLD_LOCAL), and a second build of this source loaded beside
// (ab_riccati_lanes --parent, --profile) would otherwise take the wave, and
// the shared-memory attribute, of whichever library asked first.
namespace {

template <int N, int M, int MODE, int ENUM>
bool one_lane_staged(int B, int* err) {
  constexpr int kMaxCards = 16;
  static std::atomic<long> wave[kMaxCards];  // scenarios a wave holds; 0 not yet known
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  long w = dev < kMaxCards ? wave[dev].load(std::memory_order_relaxed) : 0;
  if (e == cudaSuccess && w == 0) {
    int sms = 0, blocks = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    constexpr size_t smem = smem_bytes<N, M, MODE, true, 1, ENUM>();
    if (e == cudaSuccess && smem > 48 * 1024)
      e = cudaFuncSetAttribute(riccati_kernel<N, M, MODE, true, 1, ENUM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, riccati_kernel<N, M, MODE, true, 1, ENUM>,
                                                        kThreadsOf<true>, smem);
    w = (long)sms * blocks * kThreadsOf<true>;
    if (e == cudaSuccess && dev < kMaxCards) wave[dev].store(w, std::memory_order_relaxed);
  }
  *err = static_cast<int>(e);
  return B <= w;
}

}  // namespace

// The kernel of `mode` (a RiccatiMode) at (N, M), Staged, L lanes, the box
// QP's enumeration mode ENUM.
template <int N, int M, bool Staged, int L, int ENUM>
int launch_modes(const RiccatiArgs* args, int mode, cudaStream_t stream) {
  if (mode == kRiccatiBox) return launch<N, M, kRiccatiBox, Staged, L, ENUM>(args, stream);
  if (mode == kRiccatiMask) return launch<N, M, kRiccatiMask, Staged, L, ENUM>(args, stream);
  if (mode == kRiccatiFree) return launch<N, M, kRiccatiFree, Staged, L, ENUM>(args, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The kernel at L lanes: above one lane staged; at one lane staged or not as
// args->staged says, where a negative value asks for one_lane_staged's
// choice, which is written back to args->staged.
template <int N, int M, int L, int ENUM = kPnqpEnumDefault>
int lanes_launch_modes(RiccatiArgs* args, int mode, cudaStream_t stream) {
  if constexpr (L == 1) {
    if (args->staged < 0) {
      int err = 0;
      bool staged = false;
      if (mode == kRiccatiBox) staged = one_lane_staged<N, M, kRiccatiBox, ENUM>(args->B, &err);
      else if (mode == kRiccatiMask) staged = one_lane_staged<N, M, kRiccatiMask, ENUM>(args->B, &err);
      else staged = one_lane_staged<N, M, kRiccatiFree, ENUM>(args->B, &err);
      if (err != 0) return err;
      args->staged = staged ? 1 : 0;
    }
    if (args->staged) return launch_modes<N, M, true, 1, ENUM>(args, mode, stream);
    return launch_modes<N, M, false, 1, ENUM>(args, mode, stream);
  } else {
    return launch_modes<N, M, true, L, ENUM>(args, mode, stream);
  }
}

}  // namespace riccati_launch_detail

// The (n, m) of the port's table (ops/cuda/ilqr.py, KERNEL_SHAPES), X(N, M, A)
// for each; every other shape and enumeration mode is a variant built at first
// use (csrc/variants/riccati.cu).
#define DMPC_RICCATI_SHAPES(X, A) X(3, 1, A) X(3, 2, A) X(4, 1, A) X(4, 2, A)

// Declare the kernels of (N, M) at L lanes as built in riccati_l<L>.cu, or
// build them there.
#define DMPC_RICCATI_EXTERN_SHAPE(N_, M_, L) \
  extern template int riccati_launch_detail::lanes_launch_modes<N_, M_, L>(RiccatiArgs*, int, cudaStream_t);
#define DMPC_RICCATI_EXTERN(_, L) DMPC_RICCATI_SHAPES(DMPC_RICCATI_EXTERN_SHAPE, L)
#define DMPC_RICCATI_INSTANTIATE_SHAPE(N_, M_, L) \
  template int riccati_launch_detail::lanes_launch_modes<N_, M_, L>(RiccatiArgs*, int, cudaStream_t);
#define DMPC_RICCATI_INSTANTIATE(L) DMPC_RICCATI_SHAPES(DMPC_RICCATI_INSTANTIATE_SHAPE, L)

// Launch the sweep on `stream` with args->lanes threads per scenario (the
// resident kernel and the twin: one kernel); returns cudaGetLastError(), or
// cudaErrorInvalidValue for a lane count that is not built
// (DMPC_RICCATI_LANES) or an unknown mode.
template <int N, int M, int ENUM = kPnqpEnumDefault>
int riccati_launch(RiccatiArgs* args, int mode, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (args->lanes) {
#define DMPC_RICCATI_LANE_CASE(_, L_) \
  case L_:                            \
    return riccati_launch_detail::lanes_launch_modes<N, M, L_, ENUM>(args, mode, s);
    DMPC_RICCATI_LANES(DMPC_RICCATI_LANE_CASE, _)
#undef DMPC_RICCATI_LANE_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
