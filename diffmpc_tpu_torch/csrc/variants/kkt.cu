// A variant of the KKT backward and its twin (kkt.cu, kkt_stream.cu): the
// kernels of one shape (DMPC_N, DMPC_M) with the value update's form
// DMPC_EXACT, and their launchers (variant.cuh). csrc/build.py builds it at
// first use.

#include "kkt_launch.cuh"
#include "variant.cuh"

// Launch the resident kernel, then the twin, on `stream`; each returns
// cudaGetLastError().
extern "C" int diffmpc_kkt_backward_variant(const KktArgs* a, void* s) {
  return kkt_launch<DMPC_N, DMPC_M, kVariantExact>(a, s);
}
extern "C" int diffmpc_kkt_backward_stream_variant(const KktArgs* a, void* s) {
  return kkt_stream_launch<DMPC_N, DMPC_M, kVariantExact>(a, s);
}
