"""Plain PyTorch decode attention: one query a sequence over a (B, S_max, K,
hd) cache, keys at or past each sequence's length masked.

It is ``models/layers.py`` ``_mha_dense``'s arithmetic for one query, op
for op (fp32 from the scaled query on, the masked keys at -1e30): the CPU
path of :func:`repro_torch.kernels.decode_attention.ops.decode_attention`,
equal to ``_mha_dense`` bit for bit there, and the oracle the CUDA kernel
is held against on the card.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def reference_decode_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               kv_len: torch.Tensor) -> torch.Tensor:
    """q (B, 1, H, hd); k/v (B, S_max, K, hd), H = G*K; kv_len (B,) ->
    (B, 1, H, hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    K, Sk = k.shape[2], k.shape[1]
    G = H // K
    qf = (q * hd ** -0.5).float().reshape(B, Sq, K, G, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())   # (B,K,G,1,Sk)
    k_pos = torch.arange(Sk, device=q.device)
    live = k_pos[None, :] < kv_len.to(q.device)[:, None]         # (B, Sk)
    logits = torch.where(live[:, None, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)
