from repro_torch.configs.archs import ARCHS, get_config, optimized_config, smoke_config
from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    SSMConfig,
    XLSTMConfig,
    check_supported,
    torch_dtype,
)
from repro_torch.configs.shapes import (
    SHAPE_BY_NAME,
    SHAPES,
    InputShape,
    effective_mode,
    skip_reason,
)


def list_archs() -> list[str]:
    return sorted(ARCHS)


__all__ = [
    "ARCHS", "ModelConfig", "MoEConfig", "SSMConfig", "XLSTMConfig",
    "InputShape", "SHAPES", "SHAPE_BY_NAME", "check_supported", "effective_mode",
    "get_config", "list_archs", "optimized_config", "skip_reason", "smoke_config",
    "torch_dtype",
]
