"""Model FLOPs of a Mamba2 decoder's prefill of one prompt: the in and
out projections over the prompt's tokens, the depthwise convolution, the
SSD scan's least FLOPs (``ssd.work``) and the head at the last
position."""

from __future__ import annotations

from typing import Dict

from . import ssd


def prefill_flops(s: Dict, S: int) -> float:
    D = s["d_model"]
    d_in = s["ssm_expand"] * D
    N, P = s["ssm_state"], s["ssm_head_dim"]
    H = d_in // P
    d_conv = d_in + 2 * N
    proj = 2 * S * D * (2 * d_in + 2 * N + H) + 2 * S * d_in * D
    conv = 2 * S * s["ssm_conv_width"] * d_conv
    scan = ssd.work(1, S, H, P, N, s["ssm_chunk"], 2, False)[0]
    return float(s["num_layers"] * (proj + conv + scan)
                 + 2 * D * s["vocab_size"])
