from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ShapeSpec,
    batch_specs,
    get_config,
    get_smoke_config,
    input_specs,
    list_archs,
)

__all__ = [
    "SHAPES",
    "ModelConfig",
    "ShapeSpec",
    "batch_specs",
    "get_config",
    "get_smoke_config",
    "input_specs",
    "list_archs",
]
