// The fused iLQR kernels of every MLP architecture (nn_archs.cuh) at 16
// lanes per scenario, with and without HoistLin; ilqr_nn.cu launches them.

#include "ilqr_launch.cuh"
#include "nn_archs.cuh"

#define DMPC_ILQR_NN_L16(N_, M_, NAME, ...) DMPC_ILQR_INSTANTIATE(NNEnv_##NAME, 16)
DMPC_NN_ARCHS(DMPC_ILQR_NN_L16)
