// The MLP env step of NNDynamics, on any scalar type.
//
// A line-for-line copy of NNDynamics.entries_step
// (diffmpc_tpu/models/dynamics.py:212-239, and its port in
// diffmpc_tpu_torch/models/dynamics.py): h = [x; u]; per layer
// h_j = sum_i W[i][j] h_i + b_j, in that order, then the activation on every
// layer but the last; x + h with `residual`. The parameters are the flat
// vector of NNDynamics.kernel_params: per layer, W row-major (d_in, d_out),
// then b. With S = Dual<float, N+M> it returns the Jacobian columns [A B].
//
// The widths are template arguments, so every layer unrolls and h lives in
// registers; the instantiated architectures are nn_archs.cuh's. The kernels
// stage the parameters (at most 1024 floats: the fusable gate) once per
// block in shared memory, where every thread of a warp reads the same
// address, a broadcast: the TPU kernels' SMEM scalars.
#pragma once

#include "dual.cuh"

// The order of ACTIVATIONS in diffmpc_tpu_torch/models/dynamics.py
enum NNActivation { kNNRelu = 0, kNNTanh, kNNSigmoid, kNNElu, kNNSoftplus, kNNGelu };

template <class S>
DMPC_HD S nn_activate(int act, const S& z) {
  switch (act) {
    case kNNRelu: return dmpc_relu(z);
    case kNNTanh: return dmpc_tanh(z);
    case kNNSigmoid: return dmpc_sigmoid(z);
    case kNNElu: return dmpc_elu(z);
    case kNNSoftplus: return dmpc_softplus(z);
    default: return dmpc_gelu(z);
  }
}

// out[j] = sum_i W[i][j] h[i] + b[j], with W the (Din, Dout) row-major block
// at p and b after it
template <int Din, int Dout, class S>
DMPC_HD void nn_dense(const float* p, const S (&h)[Din], S (&out)[Dout]) {
  for (int j = 0; j < Dout; ++j) {
    S acc = p[j] * h[0];
    for (int i = 1; i < Din; ++i) acc = acc + p[i * Dout + j] * h[i];
    out[j] = acc + p[Din * Dout + j];
  }
}

// The parameter count of the layers Din -> ... -> Dout
template <int A, int B>
constexpr int nn_param_count() {
  return A * B + B;
}
template <int A, int B, int C, int... R>
constexpr int nn_param_count() {
  return A * B + B + nn_param_count<B, C, R...>();
}

// The last layer: no activation
template <class S, int Out, int Din>
DMPC_HD void nn_layers(const float* p, int, const S (&h)[Din], S (&out)[Out]) {
  nn_dense<Din, Out>(p, h, out);
}
// A hidden layer of width Dh, then the rest
template <class S, int Out, int Din, int Dh, int... Rest>
DMPC_HD void nn_layers(const float* p, int act, const S (&h)[Din], S (&out)[Out]) {
  S z[Dh];
  nn_dense<Din, Dh>(p, h, z);
  for (int j = 0; j < Dh; ++j) z[j] = nn_activate(act, z[j]);
  nn_layers<S, Out, Dh, Rest...>(p + Din * Dh + Dh, act, z, out);
}

// The env of an MLP with N states, M controls and hidden widths H...
template <int N_, int M_, int... H>
struct NNEnv {
  int activation;  // an NNActivation
  int residual;

  static constexpr int N = N_;
  static constexpr int M = M_;
  static constexpr int P = nn_param_count<N_ + M_, H..., N_>();
  // hundreds of operations a step: the fused solve's lane groups keep every
  // lane's trajectory rather than replay the chosen step (ilqr.cuh)
  static constexpr bool kCheapStep = false;

  template <class S>
  DMPC_HD void step(const float* params, const S x[N], const S u[M], S out[N]) const {
#ifdef __CUDA_ARCH__
    // Each step reads the weights anew from shared memory: without this the
    // compiler hoists the loads of all P weights out of the kernels' loops
    // over steps and holds them in registers, which spill.
    asm volatile("" : "+l"(params));
#endif
    S h[N + M], y[N];
    for (int i = 0; i < N; ++i) h[i] = x[i];
    for (int i = 0; i < M; ++i) h[N + i] = u[i];
    nn_layers<S, N, N + M, H...>(params, activation, h, y);
    for (int i = 0; i < N; ++i) out[i] = residual ? x[i] + y[i] : y[i];
  }
};

// The number of parameters an env stages in shared memory: 0 for the envs
// that read theirs from device memory (per-scenario rows, or a few scalars)
template <class Env>
struct SharedParams {
  static constexpr int count = 0;
};
template <int N, int M, int... H>
struct SharedParams<NNEnv<N, M, H...>> {
  static constexpr int count = NNEnv<N, M, H...>::P;
};
