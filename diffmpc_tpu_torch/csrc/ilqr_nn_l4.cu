// The fused iLQR kernels of every MLP architecture (nn_archs.cuh) at 4
// lanes per scenario, with and without HoistLin; ilqr_nn.cu launches them.

#include "ilqr_launch.cuh"
#include "nn_archs.cuh"

#define DMPC_ILQR_NN_L4(N_, M_, NAME, ...) DMPC_ILQR_INSTANTIATE(NNEnv_##NAME, 4)
DMPC_NN_ARCHS(DMPC_ILQR_NN_L4)
