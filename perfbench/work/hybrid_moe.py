"""Least work of a Nemotron-H decoder (``hybrid_moe``): the model FLOPs
of a prefill, the routed experts' operations and bytes in one MoE layer
call, and a whole decode step's model FLOPs and least bytes."""

from __future__ import annotations

from typing import Dict, Tuple

from . import flash, ssd


def _mamba(s: Dict) -> Dict[str, int]:
    H, P, G, N = s["ssm_heads"], s["ssm_head_dim"], s["ssm_groups"], \
        s["ssm_state"]
    d_in = H * P
    d_conv = d_in + 2 * G * N
    return dict(H=H, P=P, G=G, N=N, d_in=d_in, d_conv=d_conv,
                proj=s["d_model"] * (d_in + d_conv + H) + d_in * s["d_model"])


def layer_params(s: Dict) -> Dict[str, int]:
    """Parameters of one layer of each kind, its norm included."""
    D, E, Fe, Fs = s["d_model"], s["num_experts"], s["d_ff"], s["shared_d_ff"]
    Hq, K, hd = s["num_heads"], s["num_kv_heads"], s["head_dim"]
    m = _mamba(s)
    return {"M": m["proj"] + (s["ssm_conv_width"] + 1) * m["d_conv"]
            + 3 * m["H"] + m["d_in"] + D,
            "E": E * D + E + E * 2 * D * Fe + 2 * D * Fs + D,
            "*": 2 * D * Hq * hd + 2 * D * K * hd + D}


def moe_work(s: Dict, n: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one MoE layer's routed experts over ``n`` tokens:
    4 n k D F FLOPs (up and down); the weights of min(E, n k) experts, 2 D F
    bf16 values each, and the n k rows in (bf16) and out (fp32).  Counting
    every expert that could be hit overstates a decode step's bytes by the
    experts left without a row (about (1 - k/E)^n of them under a uniform
    router: 4.6% at 64 tokens, top-6 of 128)."""
    k, E, D, F = s["experts_per_token"], s["num_experts"], s["d_model"], \
        s["d_ff"]
    rows = n * k
    return (4.0 * rows * D * F,
            float(min(E, rows) * 2 * D * F * 2 + rows * D * (2 + 4)))


def _token_flops(s: Dict, kind: str) -> float:
    """Projection FLOPs of one token through one layer (attention's scores
    apart)."""
    D = s["d_model"]
    if kind == "M":
        m = _mamba(s)
        return 2.0 * (m["proj"] + s["ssm_conv_width"] * m["d_conv"])
    if kind == "E":
        return 2.0 * D * s["num_experts"] + 4.0 * D * (
            s["experts_per_token"] * s["d_ff"] + s["shared_d_ff"])
    Hq, K, hd = s["num_heads"], s["num_kv_heads"], s["head_dim"]
    return 2.0 * (2 * D * Hq * hd + 2 * D * K * hd)


def prefill_flops(s: Dict, S: int) -> float:
    """Model FLOPs of a prefill of one prompt of S tokens: every layer's
    projections over the tokens, the SSD scans' least FLOPs (each group
    over its heads), causal attention's pairs and the head at the last
    position."""
    m = _mamba(s)
    total = 0.0
    for kind in s["layer_pattern"]:
        total += S * _token_flops(s, kind)
        if kind == "M":
            total += m["G"] * ssd.work(1, S, m["H"] // m["G"], m["P"],
                                       m["N"], s["ssm_chunk"], 2, False)[0]
        elif kind == "*":
            total += flash.work(1, S, S, s["num_heads"], s["num_kv_heads"],
                                s["head_dim"], 2)[0]
    return total + 2.0 * s["d_model"] * s["vocab_size"]


def decode_work(s: Dict, slots: int, positions: int) -> Tuple[float, float]:
    """(model FLOPs, least bytes) of one decode step over ``slots`` rows
    with a cache of ``positions``.  FLOPs: every layer's projections per
    row, the recurrent update (4 H P N a row and layer), attention over
    the cache's positions, the head.  Bytes, bf16 weights and cache: every
    weight but the embedding table's unread rows (``slots`` rows read),
    the fp32 state and the conv state read and written, and the K/V of
    every slot's ``positions``, which the step reads whole."""
    pat = s["layer_pattern"]
    nM, nA = pat.count("M"), pat.count("*")
    D, V = s["d_model"], s["vocab_size"]
    m = _mamba(s)
    Hq, K, hd = s["num_heads"], s["num_kv_heads"], s["head_dim"]
    per = layer_params(s)
    weights = sum(per[kind] for kind in pat) + D + V * D   # + final norm, head
    flops = slots * (sum(_token_flops(s, kind) for kind in pat)
                     + nM * 4.0 * m["H"] * m["P"] * m["N"]
                     + nA * 4.0 * Hq * hd * positions + 2.0 * D * V)
    state = nM * slots * (m["H"] * m["P"] * m["N"] * 4
                          + (s["ssm_conv_width"] - 1) * m["d_conv"] * 2)
    kv = nA * slots * positions * 2 * K * hd * 2
    nbytes = 2.0 * (weights + slots * D) + 2.0 * state + kv
    return float(flops), float(nbytes)
