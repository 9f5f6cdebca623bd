// Depth-blocked unconstrained Riccati sweep on the card: one thread per
// (block, scenario).
//
// Replaces the Pallas TPU kernel riccati_backward_blocked_pallas
// (diffmpc_tpu/ops/pallas/riccati_blocked.py:445, pallas_call at :534; body
// :311-442), an instruction-level-parallelism experiment: compose adjacent
// steps' value maps so that the serial chain is T / D applies instead of T
// steps. Thread (p, s) builds and composes block p of scenario s and keeps
// the composed element in registers; the only chain across blocks hands the
// value carry from block p + 1's thread to block p's (by warp shuffles, or
// through shared memory where a scenario spans warps); each thread then
// recovers its block's gains from the carry it received
// (riccati_blocked.cuh). Where the TPU kernel kept the element levels and
// the block-boundary values in VMEM scratch, here they stay in registers and
// the thread's column of shared memory: the kernel moves C, c, F, f in and
// K, k, free out, and nothing else.
//
// What bounds it on an H100: the function must move what the free-mode sweep
// moves, about 150 B per scenario and step at n = 3, m = 1, so at large B it
// is bound by memory bandwidth (the threads along scenarios coalesce those
// loads and stores). At small B it is bound by the chain: one element, the
// tree's levels, the P - 1 applies before block 0's boundary value and
// block 0's D - 1 applies and last gains, each apply a general n x n
// elimination with n serial reciprocals and its matrix products (about
// 4n + 12 dependent operations, counted from apply_element), against the
// serial sweep's T steps of about 12; P threads a scenario spread the rest
// of the blocked work, 3-4x the serial sweep's operations, over the card.
// Measured against the serial kernel (diagnostics/ab_blocked_ilp, NVIDIA
// H100 80GB HBM3 at 700 W, chip_smoke.py phase 20): ahead where the chain
// sets the time (T=128, B=128, n=4, m=2: 0.053 against 0.280 ms; T=10,
// B=32: 0.0095 against 0.0189), behind where the batch fills the card
// (T=20, B=65,536: 0.131 against 0.064; T=128, B=8192: 0.283 against
// 0.090), where its extra
// operations and, in phase 3, the one thread in P that works at a time
// cost more than the chain it saves. A link of phase 3 takes 800-1000
// cycles, the apply's instructions issued by one thread rather than its
// dependent chain (--profile).
//
// Built by diffmpc_tpu_torch/csrc/build.py with nvcc for sm_90a, without
// --use_fast_math, and bound through the plain-C launchers below with ctypes;
// the kernel and its launch are riccati_blocked_launch.cuh's.

#include "riccati_blocked_launch.cuh"

// One launcher per (n, m) of the port's table (ops/cuda/ilqr.py
// KERNEL_SHAPES); the block D comes in the args. Each launches on `stream`
// and returns cudaGetLastError().
extern "C" int diffmpc_riccati_blocked_n3m1(RiccatiBlockedArgs* a, void* s) { return riccati_blocked_launch<3, 1>(a, s); }
extern "C" int diffmpc_riccati_blocked_n3m2(RiccatiBlockedArgs* a, void* s) { return riccati_blocked_launch<3, 2>(a, s); }
extern "C" int diffmpc_riccati_blocked_n4m1(RiccatiBlockedArgs* a, void* s) { return riccati_blocked_launch<4, 1>(a, s); }
extern "C" int diffmpc_riccati_blocked_n4m2(RiccatiBlockedArgs* a, void* s) { return riccati_blocked_launch<4, 2>(a, s); }

// The most blocks of one scenario each launcher takes at block D on the
// current device (riccati_blocked_max_blocks); returns a cudaError_t.
extern "C" int diffmpc_riccati_blocked_max_blocks_n3m1(int D, int* P) { return riccati_blocked_max_blocks<3, 1>(D, P); }
extern "C" int diffmpc_riccati_blocked_max_blocks_n3m2(int D, int* P) { return riccati_blocked_max_blocks<3, 2>(D, P); }
extern "C" int diffmpc_riccati_blocked_max_blocks_n4m1(int D, int* P) { return riccati_blocked_max_blocks<4, 1>(D, P); }
extern "C" int diffmpc_riccati_blocked_max_blocks_n4m2(int D, int* P) { return riccati_blocked_max_blocks<4, 2>(D, P); }

#ifdef DMPC_BLOCKED_PROFILE
// The profile build's cycles by phase and its CTA count
// (riccati_blocked_launch.cuh, BlockedProfile), read and cleared.
extern "C" int diffmpc_riccati_blocked_profile(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, riccati_blocked_detail::blocked_profile_cycles, 4 * sizeof(unsigned long long));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[4] = {};
  return static_cast<int>(cudaMemcpyToSymbol(riccati_blocked_detail::blocked_profile_cycles, zero, sizeof(zero)));
}
#endif
