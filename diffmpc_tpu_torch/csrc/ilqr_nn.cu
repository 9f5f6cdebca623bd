// Fused box-constrained iLQR solve on the card for learned MLP dynamics:
// the kernel of ilqr.cu (ilqr_launch.cuh) with NNDynamics's step
// (nn_mlp.cuh), one launcher per architecture of nn_archs.cuh, without and
// with the HoistLin pre-pass, at the args' lane count. The kernels
// themselves are built in ilqr_nn_l<L>.cu, one file per lane count.
//
// Replaces the Pallas TPU kernel ilqr_solve_fused
// (diffmpc_tpu/ops/pallas/ilqr.py:458, pallas_call at :592) with an
// NNDynamics entries_step, hoist_lin False and True (pre_body, :234-249).
// Each group of L threads solves its scenario (ilqr.cuh); the block first
// copies the weights (at most 1024 floats) into shared memory, where a
// warp's reads of one weight are a broadcast.
//
// What bounds it on an H100: as the pendulum's solve, the latency of each
// scenario's serial chain, now with an MLP step in it: a 3-16-16-3 step is
// ~370 dependent-free multiply-adds in 3 layers deep, ~5x that on dual
// numbers in the sweep's linearization. The pre-pass takes the
// linearization off the value carry's chain; its iterations are
// independent, and a group of L lanes shares them out.
//
// Built by csrc/build.py with nvcc for sm_90a, without --use_fast_math (the
// activations' tanhf/expf/expm1f/log1pf must stay accurate).

#include "ilqr_launch.cuh"
#include "nn_archs.cuh"

// each architecture's kernels, at every lane count, are built in ilqr_nn_l<L>.cu
#define DMPC_ILQR_NN_EXTERN(N_, M_, NAME, ...) DMPC_LANES(DMPC_ILQR_EXTERN, NNEnv_##NAME)
DMPC_NN_ARCHS(DMPC_ILQR_NN_EXTERN)

#define DMPC_ILQR_NN(N_, M_, NAME, ...)                                                              \
  extern "C" int diffmpc_ilqr_solve_nn_##NAME(const IlqrArgs* a, const NNEnv_##NAME* env, void* s) {        \
    return ilqr_launch<NNEnv_##NAME, false>(a, env, s);                                               \
  }                                                                                                  \
  extern "C" int diffmpc_ilqr_solve_nn_##NAME##_hoist(const IlqrArgs* a, const NNEnv_##NAME* env, void* s) { \
    return ilqr_launch<NNEnv_##NAME, true>(a, env, s);                                                \
  }

DMPC_NN_ARCHS(DMPC_ILQR_NN)
