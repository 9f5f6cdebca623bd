// Fused box-constrained iLQR solve on the card: one thread per scenario.
//
// Replaces the Pallas TPU kernel ilqr_solve_fused
// (diffmpc_tpu/ops/pallas/ilqr.py:458, pallas_call at :592), which runs the
// whole solve for a tile of scenarios in VMEM. Here each thread runs
// ilqr_solve_scenario (ilqr.cuh) for its own scenario: init rollout, then per
// iteration the linearization by dual numbers, the delta-form Riccati sweep
// with the box QP and masked gains, the alpha ladder, the replay and the
// best-trajectory bookkeeping. Trajectories and gains live in global scratch,
// batch-minor, so a warp's loads and stores coalesce; the value carry and
// the per-step matrices stay in registers.
//
// What bounds it on an H100: each scenario's iteration is a serial chain of
// about 1e5 flops (111,986 flops per scenario and iteration at T = 20, as
// XLA's cost analysis counts it in scripts/roofline.py), with only a few
// hundred bytes per step from memory.
// So it is bound by the latency of that chain and by occupancy, not by
// bandwidth. At B = 1024 the launch is 8 blocks of 128 threads on 132 SMs:
// most of the card idles. The B = 65,536 ensemble (512 blocks) fills it.
// Several threads per scenario, shared-memory staging and CUDA graphs are
// the ways to go faster; this first kernel is the simple one.
//
// Built by diffmpc_tpu_torch/csrc/build.py with nvcc for sm_90a, without
// --use_fast_math (the step's sinf/cosf/sqrtf must stay accurate), and
// bound through the plain-C launcher below with ctypes.

#include "ilqr_launch.cuh"
#include "pendulum.cuh"

// Launch the pendulum solve on `stream`, without and with the HoistLin
// pre-pass; each returns cudaGetLastError(). The MLPs' launchers are in
// ilqr_nn.cu.
extern "C" int diffmpc_ilqr_solve_pendulum(const IlqrArgs* args, const PendulumEnv* env, void* stream) {
  return ilqr_launch<PendulumEnv, false>(args, env, stream);
}
extern "C" int diffmpc_ilqr_solve_pendulum_hoist(const IlqrArgs* args, const PendulumEnv* env, void* stream) {
  return ilqr_launch<PendulumEnv, true>(args, env, stream);
}
