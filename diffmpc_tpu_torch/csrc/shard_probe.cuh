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
// csrc/shard_probe.cu runs it on the card as a grid over the shard; the
// tests build it with g++ for the host. ops/cuda/shard_probe.py
// (shard_probe_plain) is the same function in plain PyTorch.
#pragma once

#include <stdint.h>

#include "dual.cuh"  // DMPC_HD

// A read of the shard that no thread writes: the read-only path on the card.
DMPC_HD float probe_read(const float* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// The shard's value: three float32 adds in the body's order (no product, so
// nothing for the compiler to contract into a multiply-add).
DMPC_HD float shard_probe_value(const float* x, int L) {
  const int i1 = L - 1 < 1 ? L - 1 : 1;
  const int i2 = L - 1 < 2 ? L - 1 : 2;
  return ((probe_read(x) + probe_read(x)) + probe_read(x + i1)) + probe_read(x + i2);
}

// The floats of `out` before its first 16-byte boundary (out is 4-byte
// aligned), at most L.
DMPC_HD int shard_probe_head(const float* out, int L) {
  const int head = (int)((16 - ((uintptr_t)out & 15)) & 15) / 4;
  return head < L ? head : L;
}

// Write the value over out[0, L) as thread `first` of a grid of `stride`
// threads: the head (the floats before out's first 16-byte boundary) and
// the tail (the 0-3 floats after the last whole group of four) one at a
// time, elements first, first + stride, ... of each, and the groups of four
// between them, groups first, first + stride, ..., each as one float4 store
// on the card. On the host a grid is its threads one after another.
DMPC_HD void shard_probe_fill(const float* x, float* out, int L, long first, long stride) {
  const float v = shard_probe_value(x, L);
  const int head = shard_probe_head(out, L);
  const long quads = (L - head) / 4;
  const long tail = head + 4 * quads;
  for (long i = first; i < head; i += stride) out[i] = v;
  for (long i = tail + first; i < L; i += stride) out[i] = v;
  float* body = out + head;
  for (long q = first; q < quads; q += stride) {
#ifdef __CUDA_ARCH__
    reinterpret_cast<float4*>(body)[q] = make_float4(v, v, v, v);
#else
    for (int j = 0; j < 4; ++j) body[4 * q + j] = v;
#endif
  }
}
