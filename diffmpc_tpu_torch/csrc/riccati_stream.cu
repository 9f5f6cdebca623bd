// Streaming twin of the Riccati backward sweep on the card: the resident
// kernel's lane groups (riccati.cu), each step's slice staged once for the
// group.
//
// Replaces the Pallas TPU kernel riccati_backward_pallas_stream
// (diffmpc_tpu/ops/pallas/riccati_stream.py:171, pallas_call at :263; body
// :43-168), which the JAX package takes over the resident sweep when the
// horizon outgrows VMEM. On the card there is no VMEM to outgrow: the twin
// runs the resident kernel's riccati_sweep (riccati.cuh), where each step's
// slice is copied once for the group into a ring of shared-memory slots by
// cp.async, entries split over the lanes, riccati_stages - 1 steps ahead of
// the step the group computes, and read back as a broadcast (one lane on a
// full card reads device memory: RiccatiArgs::staged); the gains go straight
// from registers to device memory (the TPU stages its outputs only because
// its writes are DMAs).
//
// What bounds it on an H100: the same bytes as the resident kernel (each
// input read once, each output written once: ~250 B per scenario-step at
// n = 4, m = 2, box mode), so at large B memory bandwidth; at small B one
// scenario's chain of T dependent steps. Shared memory: a ring of slices and
// (L > 1) the exchange scratch for each of a block's 64 / L groups.
//
// Built by diffmpc_tpu_torch/csrc/build.py with nvcc for sm_90a, without
// --use_fast_math and without FMA contraction, the kernels in
// riccati_l<L>.cu, and bound through the plain-C launchers below with ctypes.

#include "riccati_launch.cuh"

DMPC_RICCATI_LANES(DMPC_RICCATI_EXTERN, _)

// One launcher per (n, m) of the port's table (ops/cuda/ilqr.py,
// KERNEL_SHAPES); `mode` is a RiccatiMode. Each launches on `stream` with
// args->lanes threads per scenario and returns cudaGetLastError(), or
// cudaErrorInvalidValue (riccati_launch). At one lane a negative
// args->staged asks for the launcher's staging choice and gets it back there.
extern "C" int diffmpc_riccati_stream_n3m1(RiccatiArgs* a, int mode, void* s) {
  return riccati_launch<3, 1>(a, mode, s);
}
extern "C" int diffmpc_riccati_stream_n3m2(RiccatiArgs* a, int mode, void* s) {
  return riccati_launch<3, 2>(a, mode, s);
}
extern "C" int diffmpc_riccati_stream_n4m1(RiccatiArgs* a, int mode, void* s) {
  return riccati_launch<4, 1>(a, mode, s);
}
extern "C" int diffmpc_riccati_stream_n4m2(RiccatiArgs* a, int mode, void* s) {
  return riccati_launch<4, 2>(a, mode, s);
}
