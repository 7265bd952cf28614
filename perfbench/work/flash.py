"""Causal flash attention's least work: the (query, key) pairs a causal
pass must score, two products of ``hd`` each; q, k, v read once and the
output written once."""

from __future__ import annotations


def causal_pairs(Sq: int, Skv: int, q_offset: int = 0) -> int:
    """(query, key) pairs that rows ``q_offset .. q_offset + Sq - 1`` see,
    keys capped at ``Skv``."""
    return sum(min(q_offset + i + 1, Skv) for i in range(Sq))


def work(B: int, Sq: int, Skv: int, H: int, K: int, hd: int, esize: int,
         q_offset: int = 0):
    """(FLOPs, bytes) of one causal call."""
    flops = 4.0 * B * H * causal_pairs(Sq, Skv, q_offset) * hd
    nbytes = float((2 * B * Sq * H + 2 * B * Skv * K) * hd * esize)
    return flops, nbytes
