// Riccati backward sweep on the card: a group of L threads per scenario.
//
// Replaces the Pallas TPU kernel riccati_backward_pallas
// (diffmpc_tpu/ops/pallas/riccati.py:696, pallas_call at :785; body
// :521-613), which runs the sweep t = T-1..0 for a tile of scenarios with
// the horizon in VMEM. Here each group of L threads runs riccati_sweep
// (riccati.cuh) for its own scenario: the value carry in every lane's
// registers; each step's entries of Q and q, the m = 2 box QP's candidates,
// the gains' columns and the entries of the updated value shared out over the
// lanes and exchanged through the group's scratch in shared memory; each
// step's slice staged once for the group by cp.async, a few steps ahead (one
// lane on a full card reads device memory instead: RiccatiArgs::staged, the
// launcher's choice). This is the streaming twin's kernel (riccati_stream.cu):
// on the card both read their horizon from device memory. Every L computes
// bit for bit what one thread computes.
//
// What bounds it on an H100: per scenario and step it must read C's upper
// triangle, c, F (and f, the box or the mask) once and write K, k, free (and
// n_qp) once, about 250 B at n = 4, m = 2, box mode; at large B that is the
// bytes bound. At small B one scenario's chain of T dependent steps bounds it
// (riccati_step_depth in chip_smoke.py), with L times as many threads as
// scenarios to shorten each step. Which L a batch takes is the wrapper's rule
// (ops/cuda/riccati.py, riccati_lanes), from the card's measurements.
//
// Built by diffmpc_tpu_torch/csrc/build.py with nvcc for sm_90a, without
// --use_fast_math and without FMA contraction (build.py, source_flags; the
// step fuses its sums of products by hand, riccati_mad), the kernels in
// riccati_l<L>.cu, and bound through the plain-C launchers below with
// ctypes.

#include "riccati_launch.cuh"

DMPC_RICCATI_LANES(DMPC_RICCATI_EXTERN, _)

// One launcher per (n, m) of the port's table (ops/cuda/ilqr.py,
// KERNEL_SHAPES); `mode` is a RiccatiMode. Each launches on `stream` with
// args->lanes threads per scenario and returns cudaGetLastError(), or
// cudaErrorInvalidValue (riccati_launch). At one lane a negative
// args->staged asks for the launcher's staging choice and gets it back there.
extern "C" int diffmpc_riccati_n3m1(RiccatiArgs* a, int mode, void* s) {
  return riccati_launch<3, 1>(a, mode, s);
}
extern "C" int diffmpc_riccati_n3m2(RiccatiArgs* a, int mode, void* s) {
  return riccati_launch<3, 2>(a, mode, s);
}
extern "C" int diffmpc_riccati_n4m1(RiccatiArgs* a, int mode, void* s) {
  return riccati_launch<4, 1>(a, mode, s);
}
extern "C" int diffmpc_riccati_n4m2(RiccatiArgs* a, int mode, void* s) {
  return riccati_launch<4, 2>(a, mode, s);
}
