"""Gradient compression: int8 error-feedback all-reduce (the reference's
``distributed/compression.py``).

For data-parallel gradient sync on bandwidth-constrained links: quantize
grads to int8 with a per-block scale before the reduction and keep the
quantization residual locally (error feedback), adding it back into the
next step's grads, the standard EF-SGD construction that preserves
convergence.  Quantization blocks run along the last axis of each leaf as
the reference holds it.  ``reduce`` sums the int8 payloads in int32 with an
all-reduce over the group and takes the mean of the scales:

    comp = ErrorFeedbackCompressor(block=256)
    grads, state = comp.reduce(grads, state, group)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from ..train.tree import tree_map
from .collectives import all_reduce, group_size

Params = Any


def _quant(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric signed int8 per-block quantization along the last axis."""
    last = x.shape[-1]
    pad = (-last) % block
    if pad:
        x = F.pad(x, (0, pad))
    nb = (last + pad) // block
    blocks = x.reshape(*x.shape[:-1], nb, block)
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-30
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def _dequant(q: torch.Tensor, scale: torch.Tensor, orig_last: int,
             block: int) -> torch.Tensor:
    blocks = q.float() * scale[..., None]
    flat = blocks.reshape(*q.shape[:-2], q.shape[-2] * block)
    return flat[..., :orig_last]


@dataclasses.dataclass(frozen=True)
class ErrorFeedbackCompressor:
    block: int = 256

    def init_state(self, grads: Params) -> Params:
        """Residual accumulator, same shapes as grads (fp32)."""
        return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                               device=g.device), grads)

    def compress(self, grads: Params, residual: Params
                 ) -> Tuple[Params, Params, Params]:
        """(quantized, scales, new_residual): residual holds what int8
        couldn't represent and is re-added next step."""
        def one(g, r):
            x = g.float() + r
            q, s = _quant(x, self.block)
            deq = _dequant(q, s, x.shape[-1], self.block)
            return q, s, x - deq
        triples = tree_map(one, grads, residual)
        return tuple(tree_map(lambda g, t: t[i], grads, triples)
                     for i in range(3))

    def reduce(self, grads: Params, residual: Params, group
               ) -> Tuple[Params, Params]:
        """Error-feedback compressed all-reduce over ``group``: the int8
        payloads summed in int32, the scales averaged; returns the mean."""
        qs, ss, new_residual = self.compress(grads, residual)
        n = group_size(group)

        def one(g, q, s):
            # sum int8 payloads in int32 (lossless across <=2^23 peers),
            # scales reduced separately; mean across the group
            qsum = all_reduce(q.to(torch.int32), group)
            smean = all_reduce(s.clone(), group) / n
            deq = _dequant(qsum, smean, g.shape[-1], self.block)
            return (deq / n).to(g.dtype)
        return tree_map(one, grads, qs, ss), new_residual
