// Streaming twin of the fused KKT backward on the card: the resident
// kernel's lane groups (kkt.cu), K, k and p in device memory between the
// sweeps.
//
// Replaces the Pallas TPU kernel kkt_backward_fused_stream
// (diffmpc_tpu/ops/pallas/kkt_stream.py:203, pallas_call at :273; body
// :49-200), which the JAX package takes when the horizon outgrows VMEM: three
// sweeps, each streaming its own step slices, with K, k and p staged in
// device memory between them. On the card the twin is the resident kernel's
// kkt_backward_group (kkt.cuh) with K, k and p kept in device memory: each
// step's slice (and the gains or p it reads back) copied once for the group
// into a ring of shared-memory slots by cp.async, entries split over the
// lanes, kLaneStages - 1 steps ahead of the step the group computes, read
// back by every lane (sweeps 2 and 3, and one lane, load each slice from
// device memory while the step before computes). So the twin computes bit
// for bit what the resident kernel computes.
//
// What bounds it on an H100: the resident kernel's bytes and, beside them,
// the gains and p it writes and reads back (~70 B more per scenario-step at
// n = 4, m = 2); at small B one scenario's chain of 3 T dependent steps.
//
// Built by diffmpc_tpu_torch/csrc/build.py with nvcc for sm_90a, without
// --use_fast_math and without FMA contraction, the kernels in kkt_l<L>.cu,
// and bound through the plain-C launchers below with ctypes.

#include "kkt_launch.cuh"

DMPC_KKT_LANES(DMPC_KKT_EXTERN, _)

// One launcher per (n, m) of the port's table (ops/cuda/ilqr.py,
// KERNEL_SHAPES). Each launches on `stream` with args->lanes threads per
// scenario and returns cudaGetLastError(), or cudaErrorInvalidValue
// (kkt_launch); it sets args->on_chip to 0. A negative args->prefetch asks
// for the launcher's choice and gets it back there.
extern "C" int diffmpc_kkt_backward_stream_n3m1(KktArgs* a, void* s) { return kkt_launch<3, 1>(a, true, s); }
extern "C" int diffmpc_kkt_backward_stream_n3m2(KktArgs* a, void* s) { return kkt_launch<3, 2>(a, true, s); }
extern "C" int diffmpc_kkt_backward_stream_n4m1(KktArgs* a, void* s) { return kkt_launch<4, 1>(a, true, s); }
extern "C" int diffmpc_kkt_backward_stream_n4m2(KktArgs* a, void* s) { return kkt_launch<4, 2>(a, true, s); }
