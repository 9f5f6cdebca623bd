// Fused analytic KKT backward on the card: one thread per scenario.
//
// Replaces the Pallas TPU kernel kkt_backward_fused
// (diffmpc_tpu/ops/pallas/kkt.py:245, pallas_call at :318), which runs the
// three sweeps of the backward (auxiliary Riccati, differential rollout,
// multiplier recursions) for a tile of scenarios with the whole horizon in
// VMEM. Here each thread runs kkt_backward_scenario (kkt.cuh) for its own
// scenario. The value carry and the multipliers stay in registers; the
// horizon arrays, the gains K, k and the differential trajectory p (stored
// as dc) live in global memory, batch-minor, so a warp's loads and stores
// coalesce. Nothing here depends on a fast-memory budget, so any T runs in
// this kernel; a layout for long horizons is left to the port of the
// streaming twin (kkt_stream.py).
//
// What bounds it on an H100: per scenario and step it moves about 120
// floats (~0.5 KB: C, F, tau, r read more than once, dC, dF, dc, df
// written) for a few hundred flops, so at large B it is bound by memory
// bandwidth, and at small B (B = 1024 is 8 blocks of 128 threads on 132
// SMs) by the latency of one scenario's 3 T dependent steps.
//
// Built by diffmpc_tpu_torch/csrc/build.py with nvcc for sm_90a, without
// --use_fast_math, and bound through the plain-C launchers below with ctypes;
// the kernel and its launch are kkt_launch.cuh's.

#include "kkt_launch.cuh"

// One launcher per (n, m) of the port's table (ops/cuda/ilqr.py,
// KERNEL_SHAPES): the pendulum (3, 1) and the linear problems' (3, 2),
// (4, 1), (4, 2). Each launches on `stream` and returns cudaGetLastError().
extern "C" int diffmpc_kkt_backward_n3m1(const KktArgs* a, void* s) { return kkt_launch<3, 1>(a, s); }
extern "C" int diffmpc_kkt_backward_n3m2(const KktArgs* a, void* s) { return kkt_launch<3, 2>(a, s); }
extern "C" int diffmpc_kkt_backward_n4m1(const KktArgs* a, void* s) { return kkt_launch<4, 1>(a, s); }
extern "C" int diffmpc_kkt_backward_n4m2(const KktArgs* a, void* s) { return kkt_launch<4, 2>(a, s); }
