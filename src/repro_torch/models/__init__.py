"""Model zoo (dense, ssm and hybrid families so far)."""

from .config import MLAConfig, MoEConfig, ModelConfig, SSMConfig
from .registry import build_model

__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "build_model"]
