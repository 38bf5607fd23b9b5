from repro_torch.configs.base import (
    INPUT_SHAPES,
    ModelConfig,
    ShapeSpec,
    get_config,
    list_archs,
    reduced,
    register,
)

__all__ = [
    "INPUT_SHAPES",
    "ModelConfig",
    "ShapeSpec",
    "get_config",
    "list_archs",
    "reduced",
    "register",
]
