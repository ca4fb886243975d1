from .attention import (
    flash_attention,
    flash_forward,
    flash_forward_reference,
    sdpa,
    sdpa_reference,
)

__all__ = ["flash_attention", "flash_forward", "flash_forward_reference",
           "sdpa", "sdpa_reference"]
