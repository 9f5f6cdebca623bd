// The pendulum's one env step, on any scalar type.
//
// A line-for-line copy of PendulumDx.entries_step
// (diffmpc_tpu/models/envs/pendulum.py:67-87, and its port in
// diffmpc_tpu_torch/models/envs/pendulum.py): the semi-implicit Euler step
// with the angle advanced through the rotation identity and a 1/sqrt
// normalisation, not atan2. With S = Dual<float, N+M> it returns the Jacobian
// columns [A B] as tangents.
#pragma once

#include "dual.cuh"

struct PendulumEnv {
  float max_torque;
  float max_speed;
  float dt;
  int clamp_ctrl;

  static constexpr int N = 3;  // (cos th, sin th, thdot)
  static constexpr int M = 1;  // torque
  static constexpr int P = 3;  // params (g, m, l)
  // a few dozen operations a step: the fused solve's lane groups replay the
  // chosen step rather than keep every lane's trajectory (ilqr.cuh)
  static constexpr bool kCheapStep = true;

  template <class S>
  DMPC_HD void step(const float* params, const S x[3], const S u[1], S out[3]) const {
    const float g = params[0], m = params[1], l = params[2];
    const S cos_th = x[0], sin_th = x[1], thdot = x[2];
    S uu = u[0];
    if (clamp_ctrl) uu = bclamp(uu, -max_torque, max_torque);
    S newthdot = thdot + dt * (3.0f * g / (2.0f * l) * sin_th + 3.0f * uu / (m * l * l));
    newthdot = bclamp(newthdot, -max_speed, max_speed);
    const S inv_r = dmpc_rsqrt(cos_th * cos_th + sin_th * sin_th);
    const S c_hat = cos_th * inv_r, s_hat = sin_th * inv_r;
    const S d = dt * newthdot;
    const S cd = dmpc_cos(d), sd = dmpc_sin(d);
    out[0] = c_hat * cd - s_hat * sd;
    out[1] = s_hat * cd + c_hat * sd;
    out[2] = newthdot;
  }
};
