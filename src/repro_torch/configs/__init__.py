"""Model configs of the port (a copy of the reference schema)."""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      MTPConfig, get_config, list_archs,
                                      register, smoke_config)

__all__ = ["MLAConfig", "ModelConfig", "MoEConfig", "MTPConfig",
           "get_config", "list_archs", "register", "smoke_config"]
