// The Riccati sweep's kernels at 1 lane(s) per scenario, for every (n, m) of
// the port's table and every mode: the resident kernel's and the streaming
// twin's (riccati_launch.cuh). Built by diffmpc_tpu_torch/csrc/build.py
// beside the other sources; riccati.cu and riccati_stream.cu launch them.

#include "riccati_launch.cuh"

DMPC_RICCATI_INSTANTIATE(1)
