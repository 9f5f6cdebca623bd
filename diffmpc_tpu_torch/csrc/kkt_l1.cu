// The KKT backward's kernels at 1 lane(s) per scenario, for every (n, m) of
// the port's table, with K, k and p on chip and in device memory: the
// resident kernel's and the streaming twin's (kkt_launch.cuh). Built by
// diffmpc_tpu_torch/csrc/build.py beside the other sources; kkt.cu and
// kkt_stream.cu launch them.

#include "kkt_launch.cuh"

DMPC_KKT_INSTANTIATE(1)
