"""Model FLOPs of a dense decoder's prefill of one prompt: every
projection's product over the prompt's tokens, causal attention's pairs,
and the head at the last position only (the prefill's logits)."""

from __future__ import annotations

from typing import Dict

from . import flash


def prefill_flops(s: Dict, S: int) -> float:
    D, H, K, hd, Fw = (s["d_model"], s["num_heads"], s["num_kv_heads"],
                       s["head_dim"], s["d_ff"])
    per_token = 2 * (D * H * hd + 2 * D * K * hd + H * hd * D + 3 * D * Fw)
    attn = flash.work(1, S, S, H, K, hd, 2)[0]
    return float(s["num_layers"] * (S * per_token + attn)
                 + 2 * D * s["vocab_size"])
