from repro_torch.configs.archs import ARCHS, get_config, smoke_config
from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    SSMConfig,
    XLSTMConfig,
    check_supported,
    torch_dtype,
)

__all__ = [
    "ARCHS", "ModelConfig", "MoEConfig", "SSMConfig", "XLSTMConfig",
    "check_supported", "get_config", "smoke_config", "torch_dtype",
]
