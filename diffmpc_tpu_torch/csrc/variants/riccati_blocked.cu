// A variant of the depth-blocked Riccati sweep (riccati_blocked.cu): the
// kernels of one shape (DMPC_N, DMPC_M), D = 2 and 4, and their launcher
// (variant.cuh). csrc/build.py builds it at first use.

#include "riccati_blocked_launch.cuh"
#include "variant.cuh"

// Launch on `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue
// for a block other than 2 or 4 (riccati_blocked_launch).
extern "C" int diffmpc_riccati_blocked_variant(RiccatiBlockedArgs* a, void* s) {
  return riccati_blocked_launch<DMPC_N, DMPC_M>(a, s);
}

// The most blocks of one scenario the kernel at block D takes on the current
// device (riccati_blocked_max_blocks); returns a cudaError_t.
extern "C" int diffmpc_riccati_blocked_max_blocks_variant(int D, int* P) {
  return riccati_blocked_max_blocks<DMPC_N, DMPC_M>(D, P);
}
