// The Riccati sweep's kernels at 16 lane(s) per scenario, for every (n, m) of
// the port's table and every mode: the resident kernel's and the streaming
// twin's (riccati_launch.cuh). Built by diffmpc_tpu_torch/csrc/build.py
// beside the other sources; riccati.cu and riccati_stream.cu launch them.

#include "riccati_launch.cuh"

DMPC_RICCATI_INSTANTIATE(16)

#ifdef DMPC_RICCATI_PROFILE
// The profile build's cycles by phase (riccati.cuh, RiccatiProfile), read and
// cleared.
extern "C" int diffmpc_riccati_profile(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, riccati_profile_cycles, sizeof(riccati_profile_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[12] = {};
  return static_cast<int>(cudaMemcpyToSymbol(riccati_profile_cycles, zero, sizeof(zero)));
}
#endif
