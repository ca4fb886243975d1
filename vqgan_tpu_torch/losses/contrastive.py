"""Contrastive loss: supervised contrastive (SupCon, Khosla et al. 2020).

Counterpart of vqgan_tpu/losses/contrastive.py: the label mask, anchor modes
'one' and 'all', logits stabilised by the row max, self-exclusion, and
anchors without a positive pair left out of the mean.
"""

from __future__ import annotations

import torch

__all__ = ["supcon_loss"]


def supcon_loss(features: torch.Tensor, labels: torch.Tensor | None = None,
                mask: torch.Tensor | None = None, *,
                temperature: float = 0.07, contrast_mode: str = "all",
                base_temperature: float = 0.07) -> torch.Tensor:
    """SupCon loss. features: [B, n_views, D], L2-normalised per view;
    labels [B]: same-label pairs are positives. With neither labels nor mask
    only the views of one sample are positives (SimCLR)."""
    if features.ndim != 3:
        raise ValueError("features must be [batch, n_views, dim]")
    b, n_views, _ = features.shape
    if labels is not None and mask is not None:
        raise ValueError("pass either labels or mask, not both")
    if mask is None:
        if labels is None:
            mask = torch.eye(b, device=features.device)
        else:
            labels = labels.reshape(-1, 1)
            mask = (labels == labels.T).float()

    # view-major: all of view 0, then view 1, ... (index v * B + i)
    contrast = features.transpose(0, 1).reshape(b * n_views, -1).float()
    if contrast_mode == "one":
        anchor, anchor_count = features[:, 0].float(), 1
    elif contrast_mode == "all":
        anchor, anchor_count = contrast, n_views
    else:
        raise ValueError(f"unknown contrast_mode {contrast_mode!r}")

    logits = anchor @ contrast.T / temperature
    logits = logits - logits.amax(dim=1, keepdim=True).detach()
    mask = mask.float().repeat(anchor_count, n_views)
    n_anchor = anchor_count * b
    self_mask = 1.0 - torch.eye(b * n_views, device=features.device)[:n_anchor]
    mask = mask * self_mask

    # log-sum-exp over the non-self entries (no exp-sum underflow to log 0)
    log_denom = torch.logsumexp(
        logits.masked_fill(self_mask == 0, float("-inf")), dim=1,
        keepdim=True)
    log_prob = logits - log_denom
    pos_count = mask.sum(dim=1)
    mean_log_prob_pos = torch.where(mask > 0, log_prob, 0.0).sum(dim=1) \
        / pos_count.clamp_min(1.0)
    has_pos = (pos_count > 0).float()
    loss = -(temperature / base_temperature) * mean_log_prob_pos
    return (loss * has_pos).sum() / has_pos.sum().clamp_min(1.0)

