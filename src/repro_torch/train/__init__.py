"""The training layer of the port (src/repro/train): AdamW with its
schedules and clipping, the guarded step and the loop (FSDP over placed
parameters), checkpoints in the JAX package's format (sharded leaves
included), the fault policy with ``elastic_mesh``, and gradient
compression."""
from repro_torch.train.fault import elastic_mesh
from repro_torch.train.loop import TrainConfig, TrainLoop, make_train_step
from repro_torch.train.optimizer import (
    AdamState,
    OptimizerConfig,
    abstract_init,
)

__all__ = [
    "AdamState",
    "OptimizerConfig",
    "TrainConfig",
    "TrainLoop",
    "abstract_init",
    "elastic_mesh",
    "make_train_step",
]
