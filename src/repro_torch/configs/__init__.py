from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ShapeSpec,
    get_config,
    get_smoke_config,
    list_archs,
)

__all__ = [
    "SHAPES",
    "ModelConfig",
    "ShapeSpec",
    "get_config",
    "get_smoke_config",
    "list_archs",
]
