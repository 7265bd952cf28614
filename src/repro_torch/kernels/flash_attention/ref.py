"""Plain PyTorch flash-attention forward (fp32 softmax, GQA, causal or not).

The CPU path of :func:`repro_torch.kernels.flash_attention.ops.flash_attention`
and the oracle the CUDA kernel is held against on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        q_offset: Optional[torch.Tensor] = None,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Sq, hd)  k/v: (B, K, Skv, hd), H = G*K -> (B, H, Sq, hd).
    The mask (and with it ``q_offset``) applies only when ``causal``."""
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    G = H // K
    sm_scale = sm_scale if sm_scale is not None else hd ** -0.5
    qf = q.float().reshape(B, K, G, Sq, hd) * sm_scale
    kf = k.float()
    vf = v.float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf)
    if causal:
        q_pos = torch.arange(Sq, device=q.device)[None, :]
        if q_offset is not None:
            q_pos = q_pos + q_offset.to(q.device)[:, None]
        k_pos = torch.arange(Skv, device=q.device)[None, :]
        mask = q_pos[:, :, None] >= k_pos[:, None, :]        # (B, Sq, Skv)
        s = torch.where(mask[:, None, None, :, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, vf)
    return out.reshape(B, H, Sq, hd).to(q.dtype)
