// Double-buffered streaming of per-step slices through shared memory.
//
// The KKT streaming twin (kkt_stream.cuh) copies each step's
// slice of the horizon arrays into one of two slots while the step before
// computes from the other: cp.async on the card, where the TPU kernels start
// an async DMA (pltpu.make_async_copy). The lane groups (lanes.cuh: the
// fused solve, the line search, the Riccati sweep and their twins) stage a
// group's slices with the same copies.
//
// One thread owns one scenario and copies only that scenario's entries, into
// its own column of the block's shared memory: entry e of slot s lies at
// buf[(s * size + e) * stride] with buf = smem + threadIdx.x and
// stride = blockDim.x, so a warp's copies of one entry are 32 neighbouring
// floats in device memory and 32 neighbouring banks in shared memory. A thread
// reads back only what it copied itself, so cp.async.wait_group is all the
// synchronisation it needs: no barrier, and threads past the batch's end may
// leave early. On the host (the tests' g++ build) the copies are plain
// assignments into a local array (stride 1) and the waits do nothing.
#pragma once

#include "dual.cuh"

// Copy one float from device memory into entry e of a shared-memory slot
// whose entries lie `stride` apart.
DMPC_HD void stream_put(float* slot, int stride, int e, const float* src) {
  float* dst = slot + (size_t)e * stride;
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}

// Close the group of copies issued since the last commit (one step's slice).
DMPC_HD void stream_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until at most `Pending` committed groups are still in flight.
template <int Pending>
DMPC_HD void stream_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
#endif
}

// Order this thread's stores before its later copies: a sweep that streams
// what an earlier sweep of the same thread wrote (the KKT twin's K, k, p).
DMPC_HD void stream_fence() {
#ifdef __CUDA_ARCH__
  __threadfence();
#endif
}

// The entries of one slot, read through the slice's index map S.
struct SlotReader {
  const float* p;  // entry 0 of the slot, in this thread's column
  int stride;
  DMPC_HD float operator[](int e) const { return p[(size_t)e * stride]; }
};

// The index of (i, j), j >= i, in an n x n upper triangle stored row by row.
DMPC_HD int upper_index(int n, int i, int j) { return i * n - i * (i - 1) / 2 + (j - i); }
