// A variant of the KKT backward and its twin (kkt.cu, kkt_stream.cu: one
// kernel): the kernels of one shape (DMPC_N, DMPC_M) with the value update's
// form DMPC_EXACT at the lane count DMPC_VARIANT_L, or the launchers
// (variant.cuh). csrc/build.py builds it at first use, without FMA
// contraction as the prebuilt kernels (build.py, variant_units).

#include "kkt_launch.cuh"
#include "variant.cuh"

#if DMPC_VARIANT_L > 0
template int kkt_launch_detail::lanes_launch<DMPC_N, DMPC_M, DMPC_VARIANT_L, kVariantExact>(KktArgs*, bool,
                                                                                              cudaStream_t);
#else
#define DMPC_VARIANT_KKT_EXTERN(_, L) \
  extern template int kkt_launch_detail::lanes_launch<DMPC_N, DMPC_M, L, kVariantExact>(KktArgs*, bool, cudaStream_t);
DMPC_KKT_LANES(DMPC_VARIANT_KKT_EXTERN, _)

// Launch the resident kernel, then the twin, on `stream`; each returns
// cudaGetLastError(), or cudaErrorInvalidValue (kkt_launch).
extern "C" int diffmpc_kkt_backward_variant(KktArgs* a, void* s) {
  return kkt_launch<DMPC_N, DMPC_M, kVariantExact>(a, false, s);
}
extern "C" int diffmpc_kkt_backward_stream_variant(KktArgs* a, void* s) {
  return kkt_launch<DMPC_N, DMPC_M, kVariantExact>(a, true, s);
}
#endif
