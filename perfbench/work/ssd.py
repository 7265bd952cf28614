"""The SSD scan's least work (chunked state-space duality)."""

from __future__ import annotations


def work(Bt: int, S: int, H: int, P: int, N: int, chunk: int, esize: int,
         with_init: bool):
    """Least FLOPs and bytes of one SSD scan.  FLOPs: per chunk of L
    positions, C.B^T over its causal L(L+1)/2 pairs once (B and C are
    shared by the heads), then per head the masked scores times x over the
    same pairs, the chunk's state summary (L x N x P) and, where the
    entering state is not zero, its term in y (L x N x P).  Bytes: x, B,
    C, dt, A (and init_state) read once, y and the final state written
    once."""
    Q = min(chunk, S)
    flops = 0
    for c, s0 in enumerate(range(0, S, Q)):
        L = min(Q, S - s0)
        pairs = L * (L + 1) // 2
        flops += 2 * Bt * N * pairs
        flops += 2 * Bt * H * (P * pairs + L * N * P)
        if c > 0 or with_init:
            flops += 2 * Bt * H * L * N * P
    nbytes = (2 * Bt * S * H * P * esize + 2 * Bt * S * N * esize
              + Bt * S * H * 4 + H * 4 + Bt * H * P * N * 4
              * (2 if with_init else 1))
    return float(flops), float(nbytes)
