"""Losses: next-token cross-entropy with masking + z-loss.

The softmax runs in fp32 over the vocabulary axis, as the reference's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def next_token_loss(logits: torch.Tensor, labels: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    z_loss_coef: float = 1e-4
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """logits: (B, S, V); labels: (B, S) — already aligned (labels[t] is the
    target for logits[t]).  Returns (loss, metrics)."""
    logits = logits.float()
    labels = labels.long()
    lse = torch.logsumexp(logits, dim=-1)                       # (B, S)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - gold
    z = torch.square(lse)
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(nll * mask) / denom
    zloss = z_loss_coef * torch.sum(z * mask) / denom
    metrics = {
        "nll": loss,
        "z_loss": zloss,
        "accuracy": torch.sum((torch.argmax(logits, -1) == labels) * mask)
        / denom,
    }
    return loss + zloss, metrics
