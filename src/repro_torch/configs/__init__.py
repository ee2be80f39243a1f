from .base import (MLAConfig, ModelConfig, MoEConfig, RopeScaling, SSMConfig,
                   load_arch)

__all__ = ["MLAConfig", "ModelConfig", "MoEConfig", "RopeScaling",
           "SSMConfig", "load_arch"]
