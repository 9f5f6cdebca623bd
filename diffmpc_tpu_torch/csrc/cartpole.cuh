// The cartpole's one env step, on any scalar type.
//
// A line-for-line copy of CartpoleDx.entries_step
// (diffmpc_tpu/models/envs/cartpole.py:66-96, and its port in
// diffmpc_tpu_torch/models/envs/cartpole.py): the Barto-Sutton cartpole ODE,
// Euler-integrated, with the pole's angle advanced through the rotation
// identity and a 1/sqrt normalisation, not atan2. With S = Dual<float, N+M>
// it returns the Jacobian columns [A B] as tangents.
#pragma once

#include "dual.cuh"

struct CartpoleEnv {
  float dt;
  float max_force;
  int clamp_ctrl;

  static constexpr int N = 5;  // (p, pdot, cos th, sin th, thdot)
  static constexpr int M = 1;  // force
  static constexpr int P = 4;  // params (g, m_cart, m_pole, l)
  // 40 operations a step, counted from step() below, and a sin and a cos
  // (the pendulum's 25 and a sin and a cos; the 3-16-16-3 MLP's ~770): a
  // cheap step, so the fused solve's lane groups replay the chosen step
  // rather than keep every lane's trajectory (ilqr.cuh), and the line
  // search's lanes carry several candidates a pass (rollout.cuh)
  static constexpr bool kCheapStep = true;

  template <class S>
  DMPC_HD void step(const float* params, const S x[5], const S u[1], S out[5]) const {
    const float g = params[0], m_cart = params[1], m_pole = params[2], l = params[3];
    const float total_mass = m_cart + m_pole;
    const float polemass_l = m_pole * l;
    const S p = x[0], pdot = x[1], cos_th = x[2], sin_th = x[3], thdot = x[4];
    S force = u[0];
    if (clamp_ctrl) force = bclamp(force, -max_force, max_force);
    const S temp = (force + polemass_l * thdot * thdot * sin_th) / total_mass;
    const S th_acc = (g * sin_th - cos_th * temp) / (l * (4.0f / 3.0f - m_pole * cos_th * cos_th / total_mass));
    const S p_acc = temp - polemass_l * th_acc * cos_th / total_mass;
    const S inv_r = dmpc_rsqrt(cos_th * cos_th + sin_th * sin_th);
    const S c_hat = cos_th * inv_r, s_hat = sin_th * inv_r;
    const S d = dt * thdot;
    const S cd = dmpc_cos(d), sd = dmpc_sin(d);
    out[0] = p + dt * pdot;
    out[1] = pdot + dt * p_acc;
    out[2] = c_hat * cd - s_hat * sd;
    out[3] = s_hat * cd + c_hat * sd;
    out[4] = thdot + dt * th_acc;
  }
};
