// The line-search rollout kernels of every MLP architecture (nn_archs.cuh)
// at 16 lanes per scenario, resident and streaming; rollout.cu and
// rollout_stream.cu launch them.

#include "nn_archs.cuh"
#include "rollout_launch.cuh"

#define DMPC_ROLLOUT_NN_L16(N_, M_, NAME, ...) DMPC_ROLLOUT_INSTANTIATE(NNEnv_##NAME, 16)
DMPC_NN_ARCHS(DMPC_ROLLOUT_NN_L16)
