"""The LM stack of the port (src/repro/models): the dense GQA family, the
MoE family (deepseek-v2's MLA, granite's GQA), the SSM / hybrid family
(Mamba-2's SSD, ``ssm``; zamba2's shared block) that serving runs, and
the audio and vision front ends (hubert-xlarge's bidirectional encoder
over frames, ``forward`` only; internvl2-1b's patch projector in front of
its Qwen2 stack, served), and the training loss (``loss_fn``, through
the plain attention); the serving attention reaches the hand-written
kernel on a card. ``sharding``: the logical-axis rules and the placement
of tensors on a (data, model) ``ShardMesh`` (``sharding_tree``,
``device_put``, ``ShardedTensor``); ``abstract_tree``: a schema as meta
tensors."""
from repro_torch.models.model import (
    active_param_count,
    embed_inputs,
    forward,
    loss_fn,
    model_schema,
    output_logits,
    param_count,
)
from repro_torch.models.params import (
    ParamDef,
    abstract_tree,
    bytes_params,
    cast_matrices,
    count_params,
    init_tree,
    params_from_numpy,
    sharding_tree,
    spec_tree,
)
from repro_torch.models import sharding, ssm
from repro_torch.models.sharding import (
    NamedSharding,
    PartitionSpec,
    ShardedTensor,
    ShardingRules,
    device_put,
    logical_sharding,
    logical_to_spec,
)
from repro_torch.models.transformer import run_stack

__all__ = [
    "NamedSharding",
    "ParamDef",
    "PartitionSpec",
    "ShardedTensor",
    "ShardingRules",
    "abstract_tree",
    "active_param_count",
    "bytes_params",
    "cast_matrices",
    "count_params",
    "device_put",
    "embed_inputs",
    "forward",
    "init_tree",
    "logical_sharding",
    "logical_to_spec",
    "loss_fn",
    "model_schema",
    "output_logits",
    "param_count",
    "params_from_numpy",
    "run_stack",
    "sharding",
    "sharding_tree",
    "spec_tree",
    "ssm",
]
