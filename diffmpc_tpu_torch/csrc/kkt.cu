// Fused analytic KKT backward on the card: a group of L threads per scenario.
//
// Replaces the Pallas TPU kernel kkt_backward_fused
// (diffmpc_tpu/ops/pallas/kkt.py:245, pallas_call at :318; body :164-242),
// which runs the three sweeps of the backward (auxiliary Riccati,
// differential rollout, multiplier recursions) for a tile of scenarios with
// the whole horizon in VMEM. Here each group of L threads runs
// kkt_backward_group (kkt.cuh) for its own scenario: sweep 1 is the Riccati
// sweep's step in mask mode (riccati.cuh), its entries shared out over the
// lanes, each step's slice staged once for the group by cp.async a few steps
// ahead; sweeps 2 and 3, a few products a step, run whole in every lane, the
// stores shared out, each step's slice loaded while the step before computes
// (one lane on a full card loads it at its step: the launcher's choice);
// above one lane K, k and p stay in the group's shared memory between the
// sweeps, as in the TPU kernel's VMEM scratch, where that costs the SM no
// groups (the launcher's choice), else in device memory. A C or F that
// serves every scenario is read in place (KktArgs' strides). Every L
// computes bit for bit what one thread computes.
//
// What bounds it on an H100: per scenario and step it must read C's upper
// triangle, c, F, r, tau, tight once and write dC, dc, dF, df once, about
// 470 B at n = 3, m = 1 (a C read in place counts once a step), so at large B
// the bytes; at small B one scenario's chain of 3 T dependent steps
// (kkt_step_depth in chip_smoke.py), with L times as many threads as
// scenarios to shorten each step. Which L a batch takes is the wrapper's rule
// (ops/cuda/kkt.py, kkt_lanes).
//
// Built by diffmpc_tpu_torch/csrc/build.py with nvcc for sm_90a, without
// --use_fast_math and without FMA contraction (build.py, source_flags; the
// steps fuse their sums of products by hand, riccati_mad), the kernels in
// kkt_l<L>.cu, and bound through the plain-C launchers below with ctypes.

#include "kkt_launch.cuh"

DMPC_KKT_LANES(DMPC_KKT_EXTERN, _)

// One launcher per (n, m) of the port's table (ops/cuda/ilqr.py,
// KERNEL_SHAPES): the pendulum (3, 1) and the linear problems' (3, 2),
// (4, 1), (4, 2). Each launches on `stream` with args->lanes threads per
// scenario and returns cudaGetLastError(), or cudaErrorInvalidValue
// (kkt_launch). A negative args->on_chip or args->prefetch asks for the
// launcher's choice and gets it back there.
extern "C" int diffmpc_kkt_backward_n3m1(KktArgs* a, void* s) { return kkt_launch<3, 1>(a, false, s); }
extern "C" int diffmpc_kkt_backward_n3m2(KktArgs* a, void* s) { return kkt_launch<3, 2>(a, false, s); }
extern "C" int diffmpc_kkt_backward_n4m1(KktArgs* a, void* s) { return kkt_launch<4, 1>(a, false, s); }
extern "C" int diffmpc_kkt_backward_n4m2(KktArgs* a, void* s) { return kkt_launch<4, 2>(a, false, s); }
