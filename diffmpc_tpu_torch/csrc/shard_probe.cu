// The kernel-under-the-mesh probe on the card: a grid over each rank's
// shard.
//
// Replaces the Pallas TPU kernel of tests/test_pallas_sharding.py:221 (body
// `kern` at :209-215), the JAX package's check that a hand-written kernel
// runs inside a device-mesh program. In the port every rank of a
// torch.distributed process group launches this kernel on its own device
// and current stream, on its own shard, a plain local tensor; the
// collectives that gather the shards are torch.distributed calls outside
// the kernel. Each thread computes shard_probe_value (shard_probe.cuh: three
// reads of x[0..2] through the read-only path) and stores its groups of
// four floats as float4s (shard_probe_fill).
//
// What bounds it on an H100: it moves L * 4 bytes out and 12 in and does
// three adds, so by bytes it is 0.08 us at L = 65,536 (3.35 TB/s); one
// launch costs more than that, so it is bound by launch latency at every
// shard size a rank holds. The grid covers the shard, ceil(L / (4 threads))
// blocks of up to 256 threads (one block of 32 at L = 8), capped at
// kWaves blocks an SM, so that no SM writes more than its share: one block
// over a shard of 65,536 wrote 256 floats a thread from one SM.
// diffmpc_launch_floor launches an empty kernel, the floor that launch
// latency sets, timed beside the probe.
//
// Built by diffmpc_tpu_torch/csrc/build.py with nvcc for sm_90a and bound
// through the plain-C launchers below with ctypes.

#include <cuda_runtime.h>

#include <atomic>

#include "shard_probe.cuh"

namespace {

constexpr int kMaxThreads = 256, kWaves = 4;

__global__ void __launch_bounds__(kMaxThreads) shard_probe_kernel(const float* x, float* out, int L) {
  shard_probe_fill(x, out, L, (long)blockIdx.x * blockDim.x + threadIdx.x, (long)gridDim.x * blockDim.x);
}

__global__ void launch_floor_kernel() {}

// The card's SM count, worked out once per device. In an unnamed namespace:
// a function-local static of an inline function or template would be one
// object across every library of the process (a GNU unique symbol).
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

}  // namespace

// x, out: the shard and its output, L >= 1 floats each, on the card; out
// 4-byte aligned, at any offset. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int diffmpc_shard_probe(const float* x, float* out, int L, void* stream) {
  if (L < 1) return static_cast<int>(cudaErrorInvalidValue);
  int err = 0;
  const int sms = sm_count(&err);
  if (err != 0) return err;
  const long quads = (L + 3) / 4;
  const int threads = quads >= kMaxThreads ? kMaxThreads : (int)((quads + 31) / 32 * 32);
  const long want = (quads + threads - 1) / threads;
  const int blocks = (int)(want < (long)kWaves * sms ? want : (long)kWaves * sms);
  shard_probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(x, out, L);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel of one warp on `stream`: what a launch costs alone.
// Returns cudaGetLastError().
extern "C" int diffmpc_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
