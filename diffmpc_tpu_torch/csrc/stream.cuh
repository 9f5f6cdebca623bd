// Streaming of per-step slices through shared memory by cp.async.
//
// The lane groups (lanes.cuh: the fused solve, the line search, the Riccati
// sweep, the KKT backward and their twins) copy each step's slice of the
// horizon arrays into a ring of shared-memory slots a few steps ahead of the
// step they compute: cp.async on the card, where the TPU kernels start an
// async DMA (pltpu.make_async_copy). Entry e of a slot lies at
// slot[e * stride], stride the groups of a block, so that the groups' copies
// of one entry are neighbouring floats in device memory and neighbouring
// banks in shared memory; each copy is waited for by cp.async.wait_group and
// the group's barrier (lanes.cuh). On the host (the tests' g++ build) the
// copies are plain assignments and the waits do nothing.
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

// The entries of one slot, read through the slice's index map S.
struct SlotReader {
  const float* p;  // entry 0 of the slot, in this thread's column
  int stride;
  DMPC_HD float operator[](int e) const { return p[(size_t)e * stride]; }
};

// The index of (i, j), j >= i, in an n x n upper triangle stored row by row.
DMPC_HD int upper_index(int n, int i, int j) { return i * n - i * (i - 1) / 2 + (j - i); }
