// Depth-blocked unconstrained Riccati sweep on the card: one thread per
// scenario.
//
// Replaces the Pallas TPU kernel riccati_backward_blocked_pallas
// (diffmpc_tpu/ops/pallas/riccati_blocked.py:445, pallas_call at :534; body
// :311-442), an instruction-level-parallelism experiment: compose adjacent
// steps' value maps so that the serial chain is T / D applies instead of T
// steps. Each thread runs riccati_blocked_scenario (riccati_blocked.cuh) for
// its own scenario. Where the TPU kernel kept the element levels and the
// block-boundary values in VMEM scratch, they go to device scratch here,
// allocated by the wrapper with torch.empty, batch-minor (row, B), so that a
// warp's stores and loads coalesce: per scenario
// (T + T/2 [+ T/4]) (3n^2 + 2n) + (T/D)(n^2 + n) floats, 7,776 (31 KB) at
// n = 3, T = 128, D = 4, so 255 MB at B = 8192.
//
// What bounds it on an H100: the function must move what the free-mode sweep
// moves (C, c, F, f in; K, k, free out): about 150 B per scenario and step at
// n = 3, m = 1, so at large B it is bound by memory bandwidth, the scratch
// traffic on top (about 330 B written and read again per scenario and step
// at n = 3, D = 4). At small B it is bound by one thread's chain: T / D
// applies plus D - 1 in-block steps of phase 4, each apply a general n x n
// elimination with n serial reciprocals and its matrix products (about 4n + 12
// dependent operations, counted from apply_element), where the serial sweep
// runs T steps of about 12. Phases 1, 2 and 4 have no dependence across steps
// (phase 4 none across blocks): a later design may spread them over threads,
// one per (step, scenario), the layout in which blocking could pay on a GPU.
// This one keeps one thread per scenario, the simple and right first kernel.
//
// Built by diffmpc_tpu_torch/csrc/build.py with nvcc for sm_90a, without
// --use_fast_math, and bound through the plain-C launchers below with ctypes;
// the kernel and its launch are riccati_blocked_launch.cuh's.

#include "riccati_blocked_launch.cuh"

// One launcher per (n, m) of the port's table (ops/cuda/ilqr.py
// KERNEL_SHAPES); the block D comes in the args. Each launches on `stream`
// and returns cudaGetLastError().
extern "C" int diffmpc_riccati_blocked_n3m1(const RiccatiBlockedArgs* a, void* s) { return riccati_blocked_launch<3, 1>(a, s); }
extern "C" int diffmpc_riccati_blocked_n3m2(const RiccatiBlockedArgs* a, void* s) { return riccati_blocked_launch<3, 2>(a, s); }
extern "C" int diffmpc_riccati_blocked_n4m1(const RiccatiBlockedArgs* a, void* s) { return riccati_blocked_launch<4, 1>(a, s); }
extern "C" int diffmpc_riccati_blocked_n4m2(const RiccatiBlockedArgs* a, void* s) { return riccati_blocked_launch<4, 2>(a, s); }
