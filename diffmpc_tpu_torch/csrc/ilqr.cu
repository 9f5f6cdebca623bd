// Fused box-constrained iLQR solve on the card: a group of L threads per
// scenario.
//
// Replaces the Pallas TPU kernel ilqr_solve_fused
// (diffmpc_tpu/ops/pallas/ilqr.py:458, pallas_call at :592), which runs the
// whole solve for a tile of scenarios in VMEM. Here each group of L threads
// runs ilqr_solve_scenario (ilqr.cuh) for its own scenario: init rollout,
// then per iteration the linearization by dual numbers, the delta-form
// Riccati sweep with the box QP and masked gains, the alpha ladder, the
// replay and the best-trajectory bookkeeping. Trajectories and gains live in
// global scratch, batch-minor, so a warp's loads and stores coalesce; the
// value carry and the per-step matrices stay in registers.
//
// What bounds it on an H100: each scenario's iteration is a serial chain of
// dependent operations (the sweep's step, then one rollout for the ladder
// when its rollouts run side by side, and one for the replay where the
// lanes do not keep their candidates' trajectories), with
// only a few hundred bytes per step from memory. So it is bound by the
// latency of that chain and by occupancy, not by bandwidth. With one thread
// per scenario (L = 1) the ten ladder rollouts run one after another and
// B = 1024 fills 8 blocks of 128 threads on 132 SMs; a group of L lanes runs
// L rollouts side by side, stages each step's slice ahead in shared memory,
// and fills L times as many threads. Which L a batch takes is the wrapper's
// rule (ops/cuda/ilqr.py, ilqr_lanes), from the card's measurements.
//
// Built by diffmpc_tpu_torch/csrc/build.py with nvcc for sm_90a, without
// --use_fast_math (the step's sinf/cosf/sqrtf must stay accurate), and
// bound through the plain-C launcher below with ctypes.

#include "ilqr_launch.cuh"
#include "pendulum.cuh"

// Launch the pendulum solve on `stream` with args->lanes threads per
// scenario, without and with the HoistLin pre-pass; each returns
// cudaGetLastError(). The MLPs' launchers are in ilqr_nn.cu.
extern "C" int diffmpc_ilqr_solve_pendulum(const IlqrArgs* args, const PendulumEnv* env, void* stream) {
  return ilqr_launch<PendulumEnv, false>(args, env, stream);
}
extern "C" int diffmpc_ilqr_solve_pendulum_hoist(const IlqrArgs* args, const PendulumEnv* env, void* stream) {
  return ilqr_launch<PendulumEnv, true>(args, env, stream);
}
