"""The training layer of the port (src/repro/train): AdamW with its
schedules and clipping, the guarded step and the loop, checkpoints in
the JAX package's format, the fault policy and gradient compression."""
from repro_torch.train.loop import TrainConfig, TrainLoop, make_train_step
from repro_torch.train.optimizer import AdamState, OptimizerConfig

__all__ = [
    "AdamState",
    "OptimizerConfig",
    "TrainConfig",
    "TrainLoop",
    "make_train_step",
]
