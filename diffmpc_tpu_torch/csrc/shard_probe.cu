// The kernel-under-the-mesh probe on the card: one thread block per rank's
// shard.
//
// Replaces the Pallas TPU kernel of tests/test_pallas_sharding.py:221 (body
// `kern` at :209-215), the JAX package's check that a hand-written kernel
// runs inside a device-mesh program. In the port every rank of a
// torch.distributed process group launches this kernel on its own device
// and current stream, on its own shard, a plain local tensor; the
// collectives that gather the shards are torch.distributed calls outside
// the kernel. Each thread computes shard_probe_value (shard_probe.cuh: three
// reads of x[0..2], broadcast from L1 across the block) and writes its
// strided part of the shard.
//
// What bounds it on an H100: it moves L * 4 bytes out and 12 in and does
// three adds, so by bytes it is 0.08 us at L = 65,536 (3.35 TB/s); one
// launch costs more than that, so it is bound by launch latency at every
// shard size a rank holds.
//
// Built by diffmpc_tpu_torch/csrc/build.py with nvcc for sm_90a and bound
// through the plain-C launcher below with ctypes.

#include <cuda_runtime.h>

#include "shard_probe.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) shard_probe_kernel(const float* x, float* out, int L) {
  shard_probe_fill(x, out, L, threadIdx.x, blockDim.x);
}

}  // namespace

// x, out: the shard and its output, L >= 1 floats each, on the card.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int diffmpc_shard_probe(const float* x, float* out, int L, void* stream) {
  if (L < 1) return static_cast<int>(cudaErrorInvalidValue);
  shard_probe_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, out, L);
  return static_cast<int>(cudaGetLastError());
}
