// The control-passthrough wrapper of an env step, on any scalar type.
//
// A line-for-line copy of CtrlPassthroughDynamics.entries_step
// (diffmpc_tpu/models/dynamics.py:298-302, and its port in
// diffmpc_tpu_torch/models/dynamics.py): the state is [u_tilde; x], the next
// state [u; inner(x, u)], so that the slew-rate penalty's cost sees the
// previous control (mpc._augment_slew). The step adds M copies to the inner
// step and nothing else: no operation of the inner env changes, so its
// rounding and the lane groups' bit-equality carry over.
//
// The wrapper has the inner env's fields and no others, so its host mirror
// is the inner env's ctypes struct, and its parameters are the inner env's
// (shared in shared memory where the inner env's are: SharedParams below).
#pragma once

#include "dual.cuh"
#include "nn_mlp.cuh"

template <class Inner>
struct CtrlPassthroughEnv : Inner {
  static constexpr int N = Inner::N + Inner::M;  // [u_tilde; x]
  static constexpr int M = Inner::M;
  static constexpr int P = Inner::P;
  static constexpr bool kCheapStep = Inner::kCheapStep;

  template <class S>
  DMPC_HD void step(const float* params, const S x[N], const S u[M], S out[N]) const {
    for (int i = 0; i < M; ++i) out[i] = u[i];
    Inner::step(params, x + M, u, out + M);
  }
};

template <class Inner>
struct SharedParams<CtrlPassthroughEnv<Inner>> : SharedParams<Inner> {};
