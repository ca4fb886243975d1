from .ldm_config import BaselineLDMConfig, LDMConfig

__all__ = ["BaselineLDMConfig", "LDMConfig"]
