"""A dense decoder in plain float32 (minicpm-2b's family): pre-norm
grouped-query attention with split-half RoPE, then a SwiGLU MLP, in each
layer; a final RMS norm and the (tied) embedding as the head.

The forward runs over one whole sequence, causal, with no cache: what a
served request's prompt and tokens give at each position.  Departures
from the published model are the configuration file's (``departures``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from .common import exact_fp32, head, linear, rms_norm

#: query rows of one block of the attention
Q_BLOCK = 512


def weight_spec(s: Dict) -> list:
    D, H, K, hd, Fw, V = (s["d_model"], s["num_heads"], s["num_kv_heads"],
                          s["head_dim"], s["d_ff"], s["vocab_size"])
    spec = [("embed", (V, D), ("std", 0.02))]
    for i in range(s["num_layers"]):
        p = f"layers.{i}."
        spec += [(p + "ln1", (D,), ("gain", 0.1)),
                 (p + "wq", (H * hd, D), ("fan_in", 1)),
                 (p + "wk", (K * hd, D), ("fan_in", 1)),
                 (p + "wv", (K * hd, D), ("fan_in", 1)),
                 (p + "wo", (D, H * hd), ("fan_in", 1)),
                 (p + "ln2", (D,), ("gain", 0.1)),
                 (p + "wg", (Fw, D), ("fan_in", 1)),
                 (p + "wu", (Fw, D), ("fan_in", 1)),
                 (p + "wd", (D, Fw), ("fan_in", 1))]
    spec.append(("final_norm", (D,), ("gain", 0.1)))
    if not s["tie_embeddings"]:
        spec.append(("head", (V, D), ("fan_in", 1)))
    return spec


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotation of (S, heads, hd) by position, angles in
    float64."""
    S, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Causal softmax attention, q (S, H, hd), k/v (S, K, hd), H a
    multiple of K (query head h reads KV head h // (H / K))."""
    S, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)     # (H, S, hd)
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    qh = q.transpose(0, 1) * hd ** -0.5
    out = torch.empty_like(qh)
    keys = torch.arange(S, device=q.device)
    for a in range(0, S, Q_BLOCK):
        b = min(S, a + Q_BLOCK)
        scores = qh[:, a:b] @ k[:, :b].transpose(1, 2)    # (H, rows, b)
        future = keys[None, :b] > torch.arange(a, b, device=q.device)[:, None]
        scores = scores.masked_fill(future, float("-inf"))
        out[:, a:b] = torch.softmax(scores, dim=-1) @ v[:, :b]
    return out.transpose(0, 1)


@torch.no_grad()
def logits(weights: Dict[str, torch.Tensor], s: Dict,
           tokens: torch.Tensor, positions: Sequence[int],
           quant: Optional[str] = None) -> torch.Tensor:
    """float32 logits (len(positions), V) of the sequence ``tokens``
    (S,) at ``positions``; ``quant="fp8"`` is the control's precision."""
    H, K, hd, eps = s["num_heads"], s["num_kv_heads"], s["head_dim"], \
        s["norm_eps"]
    with exact_fp32():
        x = weights["embed"][tokens].float()
        S = x.shape[0]
        for i in range(s["num_layers"]):
            w = {n: weights[f"layers.{i}.{n}"] for n in
                 ("ln1", "wq", "wk", "wv", "wo", "ln2", "wg", "wu", "wd")}
            h = rms_norm(x, w["ln1"], eps)
            q = rope(linear(h, w["wq"], quant).view(S, H, hd), s["rope_theta"])
            k = rope(linear(h, w["wk"], quant).view(S, K, hd), s["rope_theta"])
            v = linear(h, w["wv"], quant).view(S, K, hd)
            x = x + linear(attention(q, k, v).reshape(S, H * hd), w["wo"],
                           quant)
            h = rms_norm(x, w["ln2"], eps)
            x = x + linear(F.silu(linear(h, w["wg"], quant))
                           * linear(h, w["wu"], quant), w["wd"], quant)
        return head(x[list(positions)], weights, s, quant)
