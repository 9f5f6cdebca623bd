// The planar quadrotor's one env step, on any scalar type.
//
// A line-for-line copy of QuadrotorDx.entries_step
// (diffmpc_tpu/models/envs/quadrotor.py:87-113, and its port in
// diffmpc_tpu_torch/models/envs/quadrotor.py): both rotor thrusts clamped to
// [0, max_thrust], a semi-implicit Euler step. With S = Dual<float, N+M> it
// returns the Jacobian columns [A B] as tangents.
#pragma once

#include "dual.cuh"

struct QuadrotorEnv {
  float max_thrust;
  float dt;
  int clamp_ctrl;

  static constexpr int N = 6;  // (px, pz, phi, vx, vz, om)
  static constexpr int M = 2;  // rotor thrusts (u1, u2)
  static constexpr int P = 4;  // params (g, mass, arm, inertia)
  // 22 operations a step, counted from step() below, and a sin and a cos
  // (the pendulum's 25 and a sin and a cos): a cheap step (ilqr.cuh,
  // rollout.cuh)
  static constexpr bool kCheapStep = true;

  template <class S>
  DMPC_HD void step(const float* params, const S x[6], const S u[2], S out[6]) const {
    const float g = params[0], mass = params[1], arm = params[2], inertia = params[3];
    const S px = x[0], pz = x[1], phi = x[2], vx = x[3], vz = x[4], om = x[5];
    S u1 = u[0], u2 = u[1];
    if (clamp_ctrl) {
      u1 = bclamp(u1, 0.0f, max_thrust);
      u2 = bclamp(u2, 0.0f, max_thrust);
    }
    const S thrust = u1 + u2;
    const S s = dmpc_sin(phi), c = dmpc_cos(phi);
    const S nvx = vx + dt * (-thrust * s / mass);
    const S nvz = vz + dt * (thrust * c / mass - g);
    const S nom = om + dt * (arm * (u2 - u1) / inertia);
    out[0] = px + dt * nvx;
    out[1] = pz + dt * nvz;
    out[2] = phi + dt * nom;
    out[3] = nvx;
    out[4] = nvz;
    out[5] = nom;
  }
};
