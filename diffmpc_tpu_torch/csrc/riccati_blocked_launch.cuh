// The depth-blocked Riccati kernel and its launch (riccati_blocked.cuh), one
// thread per (block, scenario), for (N, M); the block D comes in the args.
//
// riccati_blocked.cu launches it for the port's table of (n, m)
// (ops/cuda/ilqr.py, KERNEL_SHAPES); every other shape is a variant built at
// first use (csrc/variants/riccati_blocked.cu).
#pragma once

#include <cuda_runtime.h>

#include <array>
#include <atomic>
#include <map>
#include <mutex>

#include "riccati_blocked.cuh"

namespace riccati_blocked_detail {

// Shared memory of the threads' columns a CTA takes while it can (half an
// SM's, so that two CTAs share one), and at most (a block's limit on sm_90).
constexpr size_t kSmemBudget = 113 * 1024, kSmemMax = 227 * 1024;

// Built with DMPC_BLOCKED_PROFILE (a diagnostic build), thread 0 of every
// CTA, block 0 of its first scenario and so the chain's last link, adds the
// cycles of its phases 1-2, its phase 3 (its wait for the chain included)
// and its phase 4 to blocked_profile_cycles[0..2], and one to [3] (read back
// and cleared by diffmpc_riccati_blocked_profile, riccati_blocked.cu).
#ifdef DMPC_BLOCKED_PROFILE
static __device__ unsigned long long blocked_profile_cycles[4];
#endif
#if defined(DMPC_BLOCKED_PROFILE) && defined(__CUDA_ARCH__)
struct BlockedProfile {
  bool on = threadIdx.x == 0;
  long long last = clock64();
  __device__ void mark(int phase) {
    const long long now = clock64();
    if (on) atomicAdd(&blocked_profile_cycles[phase], (unsigned long long)(now - last));
    last = now;
  }
  __device__ void done() {
    if (on) atomicAdd(&blocked_profile_cycles[3], 1ull);
  }
};
#else
struct BlockedProfile {
  DMPC_HD void mark(int) {}
  DMPC_HD void done() {}
};
#endif

template <int N, int M, int D>
__global__ void riccati_blocked_kernel(RiccatiBlockedArgs a, BlockedGeometry geo) {
  BlockedProfile prof;
  extern __shared__ float blocked_smem[];
  constexpr int CW = blocked_carry_floats<N>();
  const RiccatiArgs& r = a.ric;
  int s = 0, p = 0;
  bool valid = false;
  geo.place(threadIdx.x, s, p, valid);
  const int b = blockIdx.x * geo.width + s;
  valid = valid && b < r.B;
  const ElementColumn col{blocked_smem + threadIdx.x, geo.threads};

  // ---- phases 1 and 2: the block's elements and their tree ----
  ValueElement<N> top;
  StepRegs<N, M> last;
  if (valid) {
    blocked_compose<N, M, D>(r, b, p, col, top);
    last = blocked_last_inputs<N, M, D>(r, b, p);
  }
  prof.mark(0);

  // ---- phase 3, the chain: block P-1's thread first, from V_T = 0 ----
  float V[N][N], v[N], Vb[N][N], vb[N];
  for (int i = 0; i < N; ++i) {
    v[i] = vb[i] = 0.0f;
    for (int j = 0; j < N; ++j) V[i][j] = Vb[i][j] = 0.0f;
  }
  const bool shuffles = geo.shuffles();
  float* carry = blocked_smem + (size_t)geo.threads * blocked_column_floats<N>(D);
  const int src = ((int)(threadIdx.x & 31) + geo.width) & 31;
  for (int k = 0; k < geo.P; ++k) {
    const int active = geo.P - 1 - k;
    if (valid && p == active) {
      for (int i = 0; i < N; ++i) {
        vb[i] = v[i];
        for (int j = 0; j < N; ++j) Vb[i][j] = V[i][j];
      }
      apply_element<N>(top, V, v);
    }
    if (shuffles) {
      // every thread takes the carry of the thread of the next block: block
      // active - 1's thread keeps it, the others overwrite it before use
      for (int i = 0; i < N; ++i) {
        for (int j = i; j < N; ++j) {
          V[i][j] = __shfl_sync(0xffffffffu, V[i][j], src);
          V[j][i] = V[i][j];
        }
        v[i] = __shfl_sync(0xffffffffu, v[i], src);
      }
    } else {
      float* slot = carry + ((size_t)(k & 1) * geo.width + s) * CW;
      if (valid && p == active) {
        int e = 0;
        for (int i = 0; i < N; ++i)
          for (int j = i; j < N; ++j) slot[e++] = V[i][j];
        for (int i = 0; i < N; ++i) slot[e++] = v[i];
      }
      __syncthreads();
      if (valid && p == active - 1) {
        int e = 0;
        for (int i = 0; i < N; ++i)
          for (int j = i; j < N; ++j) V[i][j] = V[j][i] = slot[e++];
        for (int i = 0; i < N; ++i) v[i] = slot[e++];
      }
    }
  }

  prof.mark(1);

  // ---- phase 4: the block's gains from its right-boundary value ----
  if (valid) blocked_gains<N, M, D>(r, b, p, col, last, Vb, vb);
  prof.mark(2);
  prof.done();
}

// The caches below have internal linkage: a function-local static of an
// inline function or template is one object across every library of the
// process (GNU unique symbols bind even under RTLD_LOCAL), so a second build
// of this source loaded beside (ab_blocked_ilp --profile) would otherwise
// take this library's cache as its own and skip its kernels'
// cudaFuncSetAttribute.
namespace {

// The card's SM count, worked out once per device.
int sm_count(int* err) {
  constexpr int kMaxCards = 16;
  static std::atomic<int> sms[kMaxCards];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  int n = dev < kMaxCards ? sms[dev].load(std::memory_order_relaxed) : 0;
  if (e == cudaSuccess && n == 0) {
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && dev < kMaxCards) sms[dev].store(n, std::memory_order_relaxed);
  }
  *err = static_cast<int>(e);
  return n;
}

// What the launches of one kernel take on each device, worked out once: its
// threads a CTA at its registers (its dynamic shared memory raised to
// kSmemMax on the way) and the geometry of each (B, P) launched, so that a
// later launch makes no attribute or occupancy query.
template <int N, int M, int D>
struct LaunchCache {
  static constexpr int kMaxCards = 16;
  std::mutex mu;
  int max_threads[kMaxCards] = {};
  std::map<std::array<int, 3>, BlockedGeometry> geometry;  // (device, B, P)
};

template <int N, int M, int D>
LaunchCache<N, M, D>& launch_cache() {
  static LaunchCache<N, M, D> cache;
  return cache;
}

}  // namespace

// The kernel's threads a CTA on device `dev`; call under the cache's lock.
template <int N, int M, int D>
int max_threads_locked(int dev, int* out) {
  auto& cache = launch_cache<N, M, D>();
  if (dev < LaunchCache<N, M, D>::kMaxCards && cache.max_threads[dev] > 0) {
    *out = cache.max_threads[dev];
    return 0;
  }
  const auto kernel = riccati_blocked_kernel<N, M, D>;
  cudaFuncAttributes attr{};
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < LaunchCache<N, M, D>::kMaxCards) cache.max_threads[dev] = attr.maxThreadsPerBlock;
  *out = attr.maxThreadsPerBlock;
  return 0;
}

// The most blocks of a scenario the kernel takes on the current device.
template <int N, int M, int D>
int max_blocks(int* P) {
  int dev = 0, threads = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto& cache = launch_cache<N, M, D>();
  std::lock_guard<std::mutex> lock(cache.mu);
  const int err = max_threads_locked<N, M, D>(dev, &threads);
  if (err == 0) *P = blocked_max_blocks<N>(D, threads, kSmemMax);
  return err;
}

// The geometry of a launch over B scenarios of P blocks on the current
// device: the most scenarios a CTA, then halved while that keeps more
// (block, scenario) threads resident on an SM, by the occupancy calculator
// (CTAs that fill an SM's registers only in part: 320 threads of 128
// registers leave 192 of the 512 an SM holds idle).
template <int N, int M, int D>
int plan(int B, int P, BlockedGeometry& geo) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto& cache = launch_cache<N, M, D>();
  std::lock_guard<std::mutex> lock(cache.mu);
  const std::array<int, 3> key{dev, B, P};
  const auto found = cache.geometry.find(key);
  if (found != cache.geometry.end()) {
    geo = found->second;
    return 0;
  }
  int err = 0, threads = 0;
  const int sms = sm_count(&err);
  if (err == 0) err = max_threads_locked<N, M, D>(dev, &threads);
  if (err != 0) return err;
  if (!blocked_geometry<N>(B, P, D, sms, threads, kSmemBudget, kSmemMax, 1 << 30, geo))
    return static_cast<int>(cudaErrorInvalidValue);
  long best = -1;
  for (int cap = geo.width; cap >= 1; cap /= 2) {
    BlockedGeometry g{};
    if (!blocked_geometry<N>(B, P, D, sms, threads, kSmemBudget, kSmemMax, cap, g)) continue;
    int resident = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, riccati_blocked_kernel<N, M, D>, g.threads,
                                                      g.smem_floats<N>(D) * sizeof(float));
    if (e != cudaSuccess) return static_cast<int>(e);
    const long resident_threads = (long)resident * g.width * P;
    if (resident_threads > best) {
      best = resident_threads;
      geo = g;
    }
  }
  cache.geometry.emplace(key, geo);
  return 0;
}

template <int N, int M, int D>
int launch(RiccatiBlockedArgs* args, cudaStream_t stream) {
  const int B = args->ric.B, P = args->ric.T / D;
  if (args->ric.T % D != 0) return static_cast<int>(cudaErrorInvalidValue);
  BlockedGeometry geo{};
  const int err = plan<N, M, D>(B, P, geo);
  if (err != 0) return err;
  const size_t smem = geo.smem_floats<N>(D) * sizeof(float);
  const int blocks = (B + geo.width - 1) / geo.width;
  if (blocks > 0) riccati_blocked_kernel<N, M, D><<<blocks, geo.threads, smem, stream>>>(*args, geo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace riccati_blocked_detail

// Launch on `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue
// for a block other than 2 or 4, a T it does not divide, or more blocks of
// one scenario than one CTA holds (riccati_blocked_max_blocks).
template <int N, int M>
int riccati_blocked_launch(RiccatiBlockedArgs* args, void* stream) {
  using namespace riccati_blocked_detail;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args->block == 2) return launch<N, M, 2>(args, s);
  if (args->block == 4) return launch<N, M, 4>(args, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The most blocks of one scenario the kernel at block D takes on the current
// device, in *P (T = D *P is its longest horizon); returns a cudaError_t, or
// cudaErrorInvalidValue for a block other than 2 or 4.
template <int N, int M>
int riccati_blocked_max_blocks(int block, int* P) {
  using namespace riccati_blocked_detail;
  if (block == 2) return max_blocks<N, M, 2>(P);
  if (block == 4) return max_blocks<N, M, 4>(P);
  return static_cast<int>(cudaErrorInvalidValue);
}
