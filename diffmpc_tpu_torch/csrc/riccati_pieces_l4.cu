// The piece kernels at 4 lane(s) per scenario: the sweep in every variant
// and the rollout, staged and reading device memory
// (riccati_pieces_launch.cuh). Built by diffmpc_tpu_torch/csrc/build.py
// beside the other sources; riccati_pieces.cu launches them.

#include "riccati_pieces_launch.cuh"

DMPC_PIECES_INSTANTIATE(4)
