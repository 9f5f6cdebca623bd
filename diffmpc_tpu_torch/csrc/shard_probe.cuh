// The kernel-under-the-mesh probe on ONE rank's shard.
//
// Counterpart of the Pallas body `kern` of tests/test_pallas_sharding.py:209
// (:209-215, pallas_call at :221), which the JAX package runs under
// shard_map on a 1-D batch mesh. On each device's local shard x of length L
// it computes
//   out[:] = ((x[0] + x[0]) + x[i1]) + x[i2],   i1 = min(1, L-1), i2 = min(2, L-1),
// broadcast over the shard: the body's fori_loop over i = 0, 1, 2 adds x[i]
// to a carry that starts at x[0], and its dynamic-index reads past the
// shard clamp to the last element (a shard of 2 reads x[1] twice).
// csrc/shard_probe.cu runs it on the card, one thread block per shard; the
// tests build it with g++ for the host. ops/cuda/shard_probe.py
// (shard_probe_plain) is the same function in plain PyTorch.
#pragma once

#include "dual.cuh"  // DMPC_HD

// The shard's value: three float32 adds in the body's order (no product, so
// nothing for the compiler to contract into a multiply-add).
DMPC_HD float shard_probe_value(const float* x, int L) {
  const int i1 = L - 1 < 1 ? L - 1 : 1;
  const int i2 = L - 1 < 2 ? L - 1 : 2;
  return ((x[0] + x[0]) + x[i1]) + x[i2];
}

// Write the value to out[first], out[first + stride], ... below L: one
// thread of the block (first = its index, stride = the block's size), or
// the whole shard on the host (0, 1).
DMPC_HD void shard_probe_fill(const float* x, float* out, int L, int first, int stride) {
  const float v = shard_probe_value(x, L);
  for (int i = first; i < L; i += stride) out[i] = v;
}
