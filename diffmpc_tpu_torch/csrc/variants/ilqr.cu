// A variant of the fused iLQR solve (ilqr.cu, ilqr_nn.cu): the kernels of one
// env, the MLP of DMPC_HIDDEN at (DMPC_N, DMPC_M) or the C++ env of DMPC_ENV
// (the pendulum, the cartpole, the vehicle, the quadrotor, the acrobot), with the
// box QP's enumeration mode DMPC_ENUM and the value update's form
// DMPC_EXACT, without and with the HoistLin pre-pass, at the lane count
// DMPC_VARIANT_L, or the launchers (variant.cuh). csrc/build.py builds it at
// first use.

#include "ilqr_launch.cuh"
#include "variant.cuh"

#if defined(DMPC_HIDDEN)
using VariantEnv = VariantNNEnv;
#elif defined(DMPC_ENV)
using VariantEnv = VariantCppEnv;
#else
#error "an iLQR variant names its env: DMPC_HIDDEN or DMPC_ENV"
#endif

#if DMPC_VARIANT_L > 0
template int ilqr_launch_detail::launch<VariantEnv, false, DMPC_VARIANT_L, DMPC_ENUM, kVariantExact>(
    const IlqrArgs*, const VariantEnv*, cudaStream_t);
template int ilqr_launch_detail::launch<VariantEnv, true, DMPC_VARIANT_L, DMPC_ENUM, kVariantExact>(
    const IlqrArgs*, const VariantEnv*, cudaStream_t);
#else
#define DMPC_VARIANT_ILQR_EXTERN(_, L)                                                                      \
  extern template int ilqr_launch_detail::launch<VariantEnv, false, L, DMPC_ENUM, kVariantExact>(               \
      const IlqrArgs*, const VariantEnv*, cudaStream_t);                                                     \
  extern template int ilqr_launch_detail::launch<VariantEnv, true, L, DMPC_ENUM, kVariantExact>(                \
      const IlqrArgs*, const VariantEnv*, cudaStream_t);
DMPC_LANES(DMPC_VARIANT_ILQR_EXTERN, _)

// Launch the solve on `stream` with args->lanes threads per scenario, without
// and with the pre-pass; each returns cudaGetLastError() (ilqr_launch).
extern "C" int diffmpc_ilqr_solve_variant(const IlqrArgs* a, const VariantEnv* env, void* s) {
  return ilqr_launch<VariantEnv, false, DMPC_ENUM, kVariantExact>(a, env, s);
}
extern "C" int diffmpc_ilqr_solve_variant_hoist(const IlqrArgs* a, const VariantEnv* env, void* s) {
  return ilqr_launch<VariantEnv, true, DMPC_ENUM, kVariantExact>(a, env, s);
}
#endif
