from .ldm_config import BaselineLDMConfig, LDMConfig
from .vqgan_config import VQGANConfig

__all__ = ["BaselineLDMConfig", "LDMConfig", "VQGANConfig"]
