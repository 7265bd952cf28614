"""Flash attention in model layout, dispatched on the tensors' device.

``flash_attention(q, k, v)`` with q: (B, Sq, H, hd), k/v: (B, Skv, K, hd)
(the layout ``attention_block`` produces):

* transposes to the kernel's (B, heads, S, hd) layout,
* pads head_dim up to the kernel's 64 or 128 with zeros (kimi's 112 -> 128;
  zero columns add nothing to q.k and are sliced off the output),
* on CUDA tensors launches the hand-written Hopper kernel
  (:mod:`.kernel`) or raises; on CPU tensors runs the plain PyTorch version
  (:mod:`.ref`).  There is no fallback from one to the other.

It is a ``torch.autograd.Function``, as the reference's op is a
``custom_vjp``: the backward recomputes the attention through the plain
version on the unpadded operands and differentiates it (on both devices),
trading one more forward's FLOPs for not keeping the (Sq, Skv) scores.
``q_offset`` is integer and takes no gradient.  ``causal=False`` attends
over every key, as the reference's op does, in the forward and in the
backward's recompute alike; ``q_offset`` then plays no part.
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


def _plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offset: torch.Tensor, causal: bool) -> torch.Tensor:
    """The plain version in model layout, at the operands' own hd."""
    return reference_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               q_offset=q_offset,
                               sm_scale=q.shape[-1] ** -0.5).transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_offset, causal):
        if q.device.type not in ("cuda", "cpu", "meta"):
            raise ValueError(f"flash_attention runs on cuda, cpu or meta, "
                             f"not {q.device}")
        hd = q.shape[-1]
        hd_pad = _padded_hd(hd)
        qt, kt, vt = (_to_kernel_layout(t, hd_pad) for t in (q, k, v))
        if q.device.type == "cuda":
            out = kernel.flash_attention_fwd(qt, kt, vt, q_offset=q_offset,
                                             causal=causal, sm_scale=hd ** -0.5)
        else:   # cpu, or meta: a dry run's shapes, which launch nothing
            out = reference_attention(qt, kt, vt, causal=causal,
                                      q_offset=q_offset, sm_scale=hd ** -0.5)
        ctx.save_for_backward(q, k, v, q_offset)
        ctx.causal = causal
        return out[..., :hd].transpose(1, 2)   # back to (B, Sq, H, hd)

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_offset = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = _plain(*qkv, q_offset, ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_offset: Optional[torch.Tensor] = None,
                    causal: bool = True) -> torch.Tensor:
    """Model-layout GQA attention, causal unless ``causal=False``;
    differentiable in q, k, v."""
    if q_offset is None:
        q_offset = torch.zeros((q.shape[0],), dtype=torch.int32,
                               device=q.device)
    q_offset = q_offset.to(device=q.device, dtype=torch.int32).contiguous()
    return _FlashAttention.apply(q, k, v, q_offset, bool(causal))
