"""Decode attention in model layout, dispatched on the tensors' device.

``decode_attention(q, k_cache, v_cache, kv_len)`` with q: (B, 1, H, hd)
and the cache (B, S_max, K, hd) (the layout ``attention_block``'s decode
branch holds) launches the hand-written split-KV kernel (:mod:`.kernel`)
on CUDA tensors, which reads the cache in place up to each sequence's
length, or raises; on CPU tensors it runs the plain PyTorch version
(:mod:`.ref`).  There is no fallback from one to the other.  It takes no
gradient: training and every other attention keep their own paths.
"""

from __future__ import annotations

import torch

from . import kernel
from .ref import reference_decode_attention


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """Softmax over each sequence's keys below ``kv_len`` of q.k, then the
    weighted sum of v; (B, 1, H, hd) in q's dtype."""
    if q.device.type == "cuda":
        return kernel.decode_attention_fwd(q, k, v, kv_len)
    if q.device.type == "cpu":
        return reference_decode_attention(q, k, v, kv_len)
    raise ValueError(f"decode_attention runs on cuda or cpu, not {q.device}")
