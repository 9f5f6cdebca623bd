// A variant of the Riccati sweep (riccati.cu, riccati_stream.cu: one kernel):
// the kernels of one shape (DMPC_N, DMPC_M) in every mode, the box QP under
// the enumeration mode DMPC_ENUM, at the lane count DMPC_VARIANT_L, or the
// launchers (variant.cuh). csrc/build.py builds it at first use, without FMA
// contraction as the prebuilt sweep (build.py, variant_units).

#include "riccati_launch.cuh"
#include "variant.cuh"

#if DMPC_VARIANT_L > 0
template int riccati_launch_detail::lanes_launch_modes<DMPC_N, DMPC_M, DMPC_VARIANT_L, DMPC_ENUM>(RiccatiArgs*, int,
                                                                                                 cudaStream_t);

#if defined(DMPC_RICCATI_PROFILE) && DMPC_VARIANT_L == 16
// The profile build's cycles by phase of the 16-lane step (riccati.cuh,
// RiccatiProfile), read and cleared.
extern "C" int diffmpc_riccati_profile(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, riccati_profile_cycles, sizeof(riccati_profile_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[12] = {};
  return static_cast<int>(cudaMemcpyToSymbol(riccati_profile_cycles, zero, sizeof(zero)));
}
#endif
#else
#define DMPC_VARIANT_RICCATI_EXTERN(_, L)                                                                     \
  extern template int riccati_launch_detail::lanes_launch_modes<DMPC_N, DMPC_M, L, DMPC_ENUM>(RiccatiArgs*, int, \
                                                                                              cudaStream_t);
DMPC_RICCATI_LANES(DMPC_VARIANT_RICCATI_EXTERN, _)

// The resident sweep's launcher and the twin's, as riccati.cu's and
// riccati_stream.cu's for the table's shapes.
extern "C" int diffmpc_riccati_variant(RiccatiArgs* a, int mode, void* s) {
  return riccati_launch<DMPC_N, DMPC_M, DMPC_ENUM>(a, mode, s);
}
extern "C" int diffmpc_riccati_stream_variant(RiccatiArgs* a, int mode, void* s) {
  return riccati_launch<DMPC_N, DMPC_M, DMPC_ENUM>(a, mode, s);
}
#endif
