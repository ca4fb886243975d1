from .attention import (
    FlashAttentionFunction,
    flash_attention,
    flash_bwd_dkv,
    flash_bwd_dkv_reference,
    flash_bwd_dq,
    flash_bwd_dq_reference,
    flash_forward,
    flash_forward_reference,
    sdpa,
    sdpa_reference,
)

__all__ = ["FlashAttentionFunction", "flash_attention", "flash_bwd_dkv",
           "flash_bwd_dkv_reference", "flash_bwd_dq", "flash_bwd_dq_reference",
           "flash_forward", "flash_forward_reference", "sdpa",
           "sdpa_reference"]
