from .assignment import auction_assignment
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
from .vq import (
    VQLookupFunction,
    codebook_usage,
    ema_codebook_update,
    revive_dead_codes,
    vq_lookup,
    vq_lookup_reference,
    vq_nearest_indices,
)

__all__ = ["auction_assignment", "FlashAttentionFunction", "flash_attention", "flash_bwd_dkv",
           "flash_bwd_dkv_reference", "flash_bwd_dq", "flash_bwd_dq_reference",
           "flash_forward", "flash_forward_reference", "sdpa",
           "sdpa_reference", "VQLookupFunction", "codebook_usage",
           "ema_codebook_update", "revive_dead_codes", "vq_lookup", "vq_lookup_reference",
           "vq_nearest_indices"]
