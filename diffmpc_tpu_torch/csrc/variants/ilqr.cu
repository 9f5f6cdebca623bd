// A variant of the fused iLQR solve (ilqr.cu, ilqr_nn.cu): the kernels of one
// env, the MLP of DMPC_HIDDEN at (DMPC_N, DMPC_M) or the C++ env of DMPC_ENV
// (the pendulum, the cartpole, the vehicle, the quadrotor, the acrobot), with the
// box QP's enumeration mode DMPC_ENUM and the value update's form
// DMPC_EXACT, without and with the HoistLin pre-pass, with the sweep of
// kVariantSharedSweep, at the lane count DMPC_VARIANT_L, or the launchers
// (variant.cuh). csrc/build.py builds it at first use, without FMA
// contraction (the shared sweep's lanes fuse by hand, riccati_mad, as the
// Riccati kernel's do).

#include "ilqr_launch.cuh"
#include "variant.cuh"

#if defined(DMPC_HIDDEN)
using VariantEnv = VariantNNEnv;
#elif defined(DMPC_ENV)
using VariantEnv = VariantCppEnv;
#else
#error "an iLQR variant names its env: DMPC_HIDDEN or DMPC_ENV"
#endif

// The template arguments of the kernel at L lanes, with (HOIST true) or
// without the pre-pass: the key's env and flags, and variant.cuh's sweep
#define DMPC_VARIANT_ILQR(HOIST, L) VariantEnv, HOIST, L, DMPC_ENUM, kVariantExact, kVariantSharedSweep

#if DMPC_VARIANT_L > 0
template int ilqr_launch_detail::launch<DMPC_VARIANT_ILQR(false, DMPC_VARIANT_L)>(const IlqrArgs*, const VariantEnv*,
                                                                                  cudaStream_t);
template int ilqr_launch_detail::launch<DMPC_VARIANT_ILQR(true, DMPC_VARIANT_L)>(const IlqrArgs*, const VariantEnv*,
                                                                                 cudaStream_t);
template int ilqr_launch_detail::occupancy<DMPC_VARIANT_ILQR(false, DMPC_VARIANT_L)>(int*);
template int ilqr_launch_detail::occupancy<DMPC_VARIANT_ILQR(true, DMPC_VARIANT_L)>(int*);

#ifdef DMPC_ILQR_PROFILE
#define DMPC_ILQR_CAT2(a, b) a##b
#define DMPC_ILQR_CAT(a, b) DMPC_ILQR_CAT2(a, b)
// The profile build's cycles by phase, then its scenarios (ilqr.cuh,
// IlqrProfile), counted by this unit's kernels, read and cleared.
extern "C" int DMPC_ILQR_CAT(diffmpc_ilqr_profile_l, DMPC_VARIANT_L)(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, ilqr_profile_cycles, sizeof(ilqr_profile_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[kIlqrPhases + 1] = {};
  return static_cast<int>(cudaMemcpyToSymbol(ilqr_profile_cycles, zero, sizeof(zero)));
}
#endif
#else
#define DMPC_VARIANT_ILQR_EXTERN(_, L)                                                                            \
  extern template int ilqr_launch_detail::launch<DMPC_VARIANT_ILQR(false, L)>(const IlqrArgs*, const VariantEnv*, \
                                                                              cudaStream_t);                      \
  extern template int ilqr_launch_detail::launch<DMPC_VARIANT_ILQR(true, L)>(const IlqrArgs*, const VariantEnv*,  \
                                                                             cudaStream_t);                       \
  extern template int ilqr_launch_detail::occupancy<DMPC_VARIANT_ILQR(false, L)>(int*);                          \
  extern template int ilqr_launch_detail::occupancy<DMPC_VARIANT_ILQR(true, L)>(int*);
DMPC_LANES(DMPC_VARIANT_ILQR_EXTERN, _)

// Launch the solve on `stream` with args->lanes threads per scenario, without
// and with the pre-pass; each returns cudaGetLastError() (ilqr_launch).
extern "C" int diffmpc_ilqr_solve_variant(const IlqrArgs* a, const VariantEnv* env, void* s) {
  return ilqr_launch<VariantEnv, false, DMPC_ENUM, kVariantExact, kVariantSharedSweep>(a, env, s);
}
extern "C" int diffmpc_ilqr_solve_variant_hoist(const IlqrArgs* a, const VariantEnv* env, void* s) {
  return ilqr_launch<VariantEnv, true, DMPC_ENUM, kVariantExact, kVariantSharedSweep>(a, env, s);
}

// The kernel's registers, local memory, shared memory a block and blocks an
// SM at `lanes` lanes, without or with the pre-pass (ilqr_occupancy).
extern "C" int diffmpc_ilqr_variant_occupancy(int lanes, int hoist, int* out) {
  return hoist ? ilqr_occupancy<VariantEnv, true, DMPC_ENUM, kVariantExact, kVariantSharedSweep>(lanes, out)
               : ilqr_occupancy<VariantEnv, false, DMPC_ENUM, kVariantExact, kVariantSharedSweep>(lanes, out);
}
#endif
