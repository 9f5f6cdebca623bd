// The MLP architectures the kernels are instantiated for: X(n, m, name,
// hidden widths...), each giving the launchers diffmpc_<kind>_nn_<name>
// (ops/cuda/ilqr.py, nn_symbol) and the env type NNEnv_<name>. Keep in step with NN_KERNEL_ARCHS in
// diffmpc_tpu_torch/ops/cuda/ilqr.py: the JAX bench's 3-16-16-3
// (bench.py:597) and the shapes of the JAX package's NN tests.
#pragma once

#include "nn_mlp.cuh"

#define DMPC_NN_ARCHS(X)            \
  X(3, 1, n3m1_h16x16, 16, 16)      \
  X(3, 1, n3m1_h8, 8)               \
  X(3, 1, n3m1_h8x8, 8, 8)          \
  X(3, 1, n3m1_h16, 16)             \
  X(3, 2, n3m2_h8, 8)

#define DMPC_NN_ENV_ALIAS(N_, M_, NAME, ...) using NNEnv_##NAME = NNEnv<N_, M_, __VA_ARGS__>;
DMPC_NN_ARCHS(DMPC_NN_ENV_ALIAS)
#undef DMPC_NN_ENV_ALIAS
