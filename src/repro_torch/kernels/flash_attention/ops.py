"""Flash attention in model layout, dispatched on the tensors' device.

``flash_attention(q, k, v)`` with q: (B, Sq, H, hd), k/v: (B, Skv, K, hd)
(the layout ``attention_block`` produces):

* transposes to the kernel's (B, heads, S, hd) layout,
* pads head_dim up to the kernel's 64 or 128 with zeros (kimi's 112 -> 128;
  zero columns add nothing to q.k and are sliced off the output),
* on CUDA tensors launches the hand-written Hopper kernel
  (:mod:`.kernel`) or raises; on CPU tensors runs the plain PyTorch version
  (:mod:`.ref`).  There is no fallback from one to the other.

Forward only: the reference's ``custom_vjp`` backward (recompute through the
plain version) is training work and becomes a ``torch.autograd.Function``
in a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import kernel
from .ref import reference_attention


def _padded_hd(hd: int) -> int:
    for width in kernel.SUPPORTED_HD:
        if hd <= width:
            return width
    raise ValueError(f"head dim {hd} exceeds the kernel's largest, "
                     f"{kernel.SUPPORTED_HD[-1]}")


def _to_kernel_layout(x: torch.Tensor, hd_pad: int) -> torch.Tensor:
    x = x.transpose(1, 2)                       # (B, heads, S, hd)
    if x.shape[-1] != hd_pad:
        x = F.pad(x, (0, hd_pad - x.shape[-1]))
    return x.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Model-layout causal GQA attention forward."""
    B, Sq, H, hd = q.shape
    sm_scale = hd ** -0.5
    if q_offset is None:
        q_offset = torch.zeros((B,), dtype=torch.int32, device=q.device)
    q_offset = q_offset.to(device=q.device, dtype=torch.int32).contiguous()
    hd_pad = _padded_hd(hd)
    qt, kt, vt = (_to_kernel_layout(t, hd_pad) for t in (q, k, v))
    if q.device.type == "cuda":
        out = kernel.flash_attention_fwd(qt, kt, vt, q_offset=q_offset,
                                         sm_scale=sm_scale)
    elif q.device.type == "cpu":
        out = reference_attention(qt, kt, vt, q_offset=q_offset,
                                  sm_scale=sm_scale)
    else:
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return out[..., :hd].transpose(1, 2)       # back to (B, Sq, H, hd)
