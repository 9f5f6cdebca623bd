"""Training steps of the port (counterpart of :mod:`diffmpc_tpu.parallel`)."""

from .training import (
    StepStats,
    TrainState,
    generate_expert_data,
    imitation_loss,
    init_train_state,
    make_dp_train_step,
)

__all__ = [
    "StepStats",
    "TrainState",
    "generate_expert_data",
    "imitation_loss",
    "init_train_state",
    "make_dp_train_step",
]
