// Streaming twin of the fused KKT backward on the card: one thread per
// scenario, each sweep's per-step inputs double-buffered through shared
// memory.
//
// Replaces the Pallas TPU kernel kkt_backward_fused_stream
// (diffmpc_tpu/ops/pallas/kkt_stream.py:203, pallas_call at :273; body
// :49-200), which the JAX package takes when the horizon outgrows VMEM. Each
// thread runs kkt_stream_scenario (kkt_stream.cuh): three sweeps, each
// streaming its own slices by cp.async into one slot while the step before
// computes from the other; K, k and p staged in device memory between the
// sweeps; the value carry and the multipliers in registers.
//
// What bounds it on an H100: the bytes it must move (inputs once, outputs
// once: ~280 B per scenario-step at n = 3, m = 1, ~500 B at n = 4, m = 2) at
// large B; it also writes and reads back K, k, p. At small B the latency of
// 3 T dependent steps. Shared memory: 2 slots x 68 floats x 64 threads
// (35 KB) at n = 4, m = 2.
//
// Built by diffmpc_tpu_torch/csrc/build.py with nvcc for sm_90a, without
// --use_fast_math, and bound through the plain-C launchers below with ctypes;
// the kernel and its launch are kkt_launch.cuh's.

#include "kkt_launch.cuh"

// One launcher per (n, m) of the port's table (ops/cuda/ilqr.py,
// KERNEL_SHAPES). Each launches on `stream` and returns cudaGetLastError().
extern "C" int diffmpc_kkt_backward_stream_n3m1(const KktArgs* a, void* s) { return kkt_stream_launch<3, 1>(a, s); }
extern "C" int diffmpc_kkt_backward_stream_n3m2(const KktArgs* a, void* s) { return kkt_stream_launch<3, 2>(a, s); }
extern "C" int diffmpc_kkt_backward_stream_n4m1(const KktArgs* a, void* s) { return kkt_stream_launch<4, 1>(a, s); }
extern "C" int diffmpc_kkt_backward_stream_n4m2(const KktArgs* a, void* s) { return kkt_stream_launch<4, 2>(a, s); }
