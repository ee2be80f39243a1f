from .base import MLAConfig, ModelConfig, MoEConfig, SSMConfig, load_arch

__all__ = ["MLAConfig", "ModelConfig", "MoEConfig", "SSMConfig", "load_arch"]
