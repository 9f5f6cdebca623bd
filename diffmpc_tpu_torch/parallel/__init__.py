"""Data-parallel training over ``torch.distributed`` (counterpart of :mod:`diffmpc_tpu.parallel`)."""

from .mesh import (
    BATCH_AXIS,
    Mesh,
    batch_sharding,
    gather_results,
    make_mesh,
    replicate,
    replicated,
    shard_batch,
)
from .training import (
    StepStats,
    TrainState,
    generate_expert_data,
    imitation_loss,
    init_train_state,
    make_dp_train_step,
)

__all__ = [
    "BATCH_AXIS",
    "Mesh",
    "StepStats",
    "TrainState",
    "batch_sharding",
    "gather_results",
    "generate_expert_data",
    "imitation_loss",
    "init_train_state",
    "make_dp_train_step",
    "make_mesh",
    "replicate",
    "replicated",
    "shard_batch",
]
