// A variant of the line search and its twin (rollout.cu, rollout_stream.cu):
// the kernels of one shape (DMPC_N, DMPC_M), for linear dynamics or the C++
// env of DMPC_ENV (staged, both launchers, as the prebuilt ones of linear
// dynamics and the pendulum) or the MLP of DMPC_HIDDEN (resident and
// staged), at the lane count DMPC_VARIANT_L, or the launchers (variant.cuh).
// csrc/build.py builds it at first use.

#include "rollout_launch.cuh"
#include "variant.cuh"

#ifdef DMPC_HIDDEN
#define DMPC_VARIANT_ROLLOUT(PREFIX, L)                                                                          \
  PREFIX template int rollout_launch_detail::launch<DMPC_N, DMPC_M, VariantNNEnv, false, L>(                     \
      const RolloutArgs*, const VariantNNEnv&, cudaStream_t);                                                    \
  PREFIX template int rollout_launch_detail::launch<DMPC_N, DMPC_M, VariantNNEnv, true, L>(                      \
      const RolloutArgs*, const VariantNNEnv&, cudaStream_t);
#elif defined(DMPC_ENV)
#define DMPC_VARIANT_ROLLOUT(PREFIX, L)                                                                          \
  PREFIX template int rollout_launch_detail::launch<DMPC_N, DMPC_M, VariantCppEnv, true, L>(                     \
      const RolloutArgs*, const VariantCppEnv&, cudaStream_t);
#else
#define DMPC_VARIANT_ROLLOUT(PREFIX, L)                                                                          \
  PREFIX template int rollout_launch_detail::launch<DMPC_N, DMPC_M, LinearEnv, true, L>(const RolloutArgs*,      \
                                                                                       const LinearEnv&,         \
                                                                                       cudaStream_t);
#endif

#if DMPC_VARIANT_L > 0
DMPC_VARIANT_ROLLOUT(, DMPC_VARIANT_L)

#ifdef DMPC_ROLLOUT_PROFILE
#define DMPC_ROLLOUT_CAT2(a, b) a##b
#define DMPC_ROLLOUT_CAT(a, b) DMPC_ROLLOUT_CAT2(a, b)
// The profile build's cycles by phase, then its scenarios (rollout.cuh,
// RolloutProfile), counted by this unit's kernels, read and cleared.
extern "C" int DMPC_ROLLOUT_CAT(diffmpc_rollout_profile_l, DMPC_VARIANT_L)(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, rollout_profile_cycles, sizeof(rollout_profile_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[kRolloutPhases + 1] = {};
  return static_cast<int>(cudaMemcpyToSymbol(rollout_profile_cycles, zero, sizeof(zero)));
}
#endif
#else
DMPC_LANES(DMPC_VARIANT_ROLLOUT, extern)

// Launch the line search (resident, then the twin) on `stream` with
// args->lanes threads per scenario; each returns cudaGetLastError(), or
// cudaErrorInvalidValue (rollout_launch).
#ifdef DMPC_HIDDEN
extern "C" int diffmpc_rollout_variant(const RolloutArgs* a, const VariantNNEnv* env, void* s) {
  return rollout_launch<DMPC_N, DMPC_M, false>(a, *env, s);
}
extern "C" int diffmpc_rollout_stream_variant(const RolloutArgs* a, const VariantNNEnv* env, void* s) {
  return rollout_launch<DMPC_N, DMPC_M, true>(a, *env, s);
}
#elif defined(DMPC_ENV)
extern "C" int diffmpc_rollout_variant(const RolloutArgs* a, const VariantCppEnv* env, void* s) {
  return rollout_launch<DMPC_N, DMPC_M, true>(a, *env, s);
}
extern "C" int diffmpc_rollout_stream_variant(const RolloutArgs* a, const VariantCppEnv* env, void* s) {
  return rollout_launch<DMPC_N, DMPC_M, true>(a, *env, s);
}
#else
extern "C" int diffmpc_rollout_variant(const RolloutArgs* a, void* s) {
  return rollout_launch<DMPC_N, DMPC_M, true>(a, LinearEnv{}, s);
}
extern "C" int diffmpc_rollout_stream_variant(const RolloutArgs* a, void* s) {
  return rollout_launch<DMPC_N, DMPC_M, true>(a, LinearEnv{}, s);
}
#endif
#endif
