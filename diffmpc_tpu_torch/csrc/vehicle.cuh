// The kinematic-bicycle vehicle's one env step, on any scalar type.
//
// A line-for-line copy of VehicleDx._step (diffmpc_tpu/models/envs/
// vehicle.py:72-85), which its forward and entries_step share, and of its
// port in diffmpc_tpu_torch/models/envs/vehicle.py: the asymmetric control
// clamps, the speed clamped to [0, max_speed], tan written as sin / cos, a
// semi-implicit Euler step. With S = Dual<float, N+M> it returns the
// Jacobian columns [A B] as tangents.
#pragma once

#include "dual.cuh"

struct VehicleEnv {
  float max_accel;
  float max_brake;
  float max_steer;
  float max_speed;
  float dt;
  int clamp_ctrl;

  static constexpr int N = 4;  // (px, py, psi, v)
  static constexpr int M = 2;  // (a, delta)
  static constexpr int P = 2;  // params (wheelbase L, drag c_d)
  // 15 operations a step, counted from step() below, and two sines and two
  // cosines (the pendulum's 25 and a sin and a cos): a cheap step (ilqr.cuh,
  // rollout.cuh)
  static constexpr bool kCheapStep = true;

  template <class S>
  DMPC_HD void step(const float* params, const S x[4], const S u[2], S out[4]) const {
    const float L = params[0], c_d = params[1];
    const S px = x[0], py = x[1], psi = x[2], v = x[3];
    S a = u[0], delta = u[1];
    if (clamp_ctrl) {
      a = bclamp(a, -max_brake, max_accel);
      delta = bclamp(delta, -max_steer, max_steer);
    }
    const S nv = bclamp(v + dt * (a - c_d * v), 0.0f, max_speed);
    // tan via sin / cos: pole-free for |delta| <= 0.5
    const S tan_d = dmpc_sin(delta) / dmpc_cos(delta);
    const S npsi = psi + dt * nv * tan_d / L;
    out[0] = px + dt * nv * dmpc_cos(npsi);
    out[1] = py + dt * nv * dmpc_sin(npsi);
    out[2] = npsi;
    out[3] = nv;
  }
};
