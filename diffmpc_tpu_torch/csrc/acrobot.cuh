// The acrobot's one env step, on any scalar type.
//
// A line-for-line copy of AcrobotDx.entries_step and _accelerations
// (diffmpc_tpu/models/envs/acrobot.py:63-97 and :120-145, and their port in
// diffmpc_tpu_torch/models/envs/acrobot.py): the closed-form 2x2 solve
// M(q) qdd = rhs with its state-dependent determinant, the two speed clamps,
// and both angles advanced through the rotation identity and a 1/sqrt
// normalisation, not atan2. With S = Dual<float, N+M> it returns the
// Jacobian columns [A B] as tangents.
#pragma once

#include "dual.cuh"

struct AcrobotEnv {
  float max_torque;
  float max_speed1;
  float max_speed2;
  float dt;
  int clamp_ctrl;

  static constexpr int N = 6;  // (cos th1, sin th1, cos th2, sin th2, om1, om2)
  static constexpr int M = 1;  // elbow torque
  static constexpr int P = 4;  // params (m1, m2, l1, l2)
  // gravity, fixed (acrobot.py's _G)
  static constexpr float kG = 9.8f;
  // 106 operations a step, counted from step() below (two of them
  // divisions by the determinant), and two sines and two cosines: about four
  // times the pendulum's 25, a seventh of the 3-16-16-3 MLP's ~770. Cheap, as
  // measured against a build with the other flag
  // (diagnostics/ab_cheap_step.py; ops/cuda/ilqr.py, _CPP_ENVS): its lanes
  // carry the line search's candidates side by side (rollout.cuh) and the
  // fused solve's lane groups replay the chosen step (ilqr.cuh), as the
  // pendulum's do
  static constexpr bool kCheapStep = true;

  // (c, s) of the angle advanced by d, normalised first
  template <class E>
  DMPC_HD static void rotate(const E& c, const E& s, const E& d, E& nc, E& ns) {
    const E inv_r = dmpc_rsqrt(c * c + s * s);
    const E c_hat = c * inv_r, s_hat = s * inv_r;
    const E cd = dmpc_cos(d), sd = dmpc_sin(d);
    nc = c_hat * cd - s_hat * sd;
    ns = s_hat * cd + c_hat * sd;
  }

  // The step computes on NoContract<S> (dual.cuh), its parameters' products
  // by nc_mul and nc_add: built with contraction as the line search is,
  // nvcc fused the step's products differently at one lane and at two, and
  // the lane counts parted bit for bit; uncontracted, every instantiation
  // rounds the operations as written, in the order of the JAX package's
  // step, as the plain version does.
  template <class S>
  DMPC_HD void step(const float* params, const S x[6], const S u[1], S out[6]) const {
    using E = typename NoContract<S>::type;
    const float m1 = params[0], m2 = params[1], l1 = params[2], l2 = params[3];
    const E c1 = x[0], s1 = x[1], c2 = x[2], s2 = x[3], om1 = x[4], om2 = x[5];
    E tau = u[0];
    if (clamp_ctrl) tau = bclamp(tau, -max_torque, max_torque);

    // _accelerations: qdd = M(q)^{-1} (B tau - C(q, qd) qd - G(q))
    const float lc1 = nc_mul(0.5f, l1), lc2 = nc_mul(0.5f, l2);
    const float i1 = nc_mul(nc_mul(m1, l1), l1) / 12.0f;
    const float i2 = nc_mul(nc_mul(m2, l2), l2) / 12.0f;
    const float lc2_sq = nc_mul(lc2, lc2), l1_lc2 = nc_mul(l1, lc2);
    // m11 = m1 lc1^2 + i1 + m2 (l1^2 + lc2^2 + 2 l1 lc2 cos th2) + i2
    const E m11 = (nc_add(nc_mul(nc_mul(m1, lc1), lc1), i1) +
                   m2 * (nc_add(nc_mul(l1, l1), lc2_sq) + nc_mul(nc_mul(2.0f, l1), lc2) * c2)) + i2;
    const E m12 = m2 * (lc2_sq + l1_lc2 * c2) + i2;
    const float m22 = nc_add(nc_mul(nc_mul(m2, lc2), lc2), i2);
    const E h = nc_mul(nc_mul(m2, l1), lc2) * s2;
    const E cor1 = -h * om2 * om2 - 2.0f * h * om1 * om2;
    const E cor2 = h * om1 * om1;
    // th from upright: U = (m1 lc1 + m2 l1) g cos th1 + m2 lc2 g cos(th1 + th2)
    const E s12 = s1 * c2 + c1 * s2;
    const E g1 = nc_mul(-nc_add(nc_mul(m1, lc1), nc_mul(m2, l1)), kG) * s1 - nc_mul(nc_mul(m2, lc2), kG) * s12;
    const E g2 = nc_mul(nc_mul(-m2, lc2), kG) * s12;
    const E b1 = -cor1 - g1;
    const E b2 = tau - cor2 - g2;
    const E det = m11 * m22 - m12 * m12;
    const E qdd1 = (m22 * b1 - m12 * b2) / det;
    const E qdd2 = (m11 * b2 - m12 * b1) / det;

    const E nom1 = bclamp(om1 + dt * qdd1, -max_speed1, max_speed1);
    const E nom2 = bclamp(om2 + dt * qdd2, -max_speed2, max_speed2);
    E nc1, ns1, nc2, ns2;
    rotate(c1, s1, E(dt * nom1), nc1, ns1);
    rotate(c2, s2, E(dt * nom2), nc2, ns2);
    out[0] = nc_out(nc1);
    out[1] = nc_out(ns1);
    out[2] = nc_out(nc2);
    out[3] = nc_out(ns2);
    out[4] = nc_out(nom1);
    out[5] = nc_out(nom2);
  }
};
