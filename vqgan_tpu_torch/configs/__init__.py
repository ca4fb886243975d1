from .ldm_config import LDMConfig

__all__ = ["LDMConfig"]
