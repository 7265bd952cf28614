"""Losses: next-token cross-entropy with masking + z-loss.

The softmax runs in fp32 over the vocabulary axis, as the reference's.

Under a mesh (``env``) each rank holds its part of the batch, so the mean
is over the *global* count of valid tokens (an all-reduce over the batch
axes): the rank's loss is its sum over that count, and the ranks' losses
(and gradients) add up to the global mean.  Where the logits are split
over tp by vocabulary (``models/layers.py`` ``vocab_parallel``), the
log-sum-exp is vocab-parallel: the max is all-reduced (a MAX, outside the
graph: it only steadies the exponentials), the sum of exponentials and the
label's logit are all-reduced over tp with the gradient passed through
(``collectives.reduce_from``), and the accuracy's argmax is taken across
the shards (the first maximal logit, as ``argmax`` over the whole
vocabulary).  The metrics are global.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..distributed.collectives import all_gather, all_reduce, reduce_from


def _vocab_parallel_terms(env, logits: torch.Tensor, labels: torch.Tensor):
    """(lse, gold, prediction) of vocab-split fp32 ``logits``."""
    group = env.tp_group
    v_l = logits.shape[-1]
    lo = env.tp_rank * v_l
    top, arg = logits.detach().max(dim=-1)
    m = all_reduce(top.clone(), group, op="max")
    lse = m + torch.log(reduce_from(
        torch.exp(logits - m[..., None]).sum(dim=-1), group))
    local = labels - lo
    inside = (local >= 0) & (local < v_l)
    picked = torch.gather(logits, -1,
                          local.clamp(0, v_l - 1)[..., None])[..., 0]
    gold = reduce_from(torch.where(inside, picked, torch.zeros_like(picked)),
                       group)
    tops = all_gather(top[None], group, dim=0)             # (tp, B, S)
    args = all_gather((arg + lo)[None], group, dim=0)
    pred = torch.gather(args, 0, tops.argmax(dim=0)[None])[0]
    return lse, gold, pred


def next_token_loss(logits: torch.Tensor, labels: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    z_loss_coef: float = 1e-4, *, env=None,
                    vocab_parallel: bool = False
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """logits: (B, S, V); labels: (B, S) — already aligned (labels[t] is the
    target for logits[t]).  Returns (loss, metrics).  ``env``: the mesh's
    (the rank's part of the batch; ``vocab_parallel``: the logits are the
    rank's block of the vocabulary); the loss is then the rank's share and
    the metrics global."""
    logits = logits.float()
    labels = labels.long()
    if vocab_parallel:
        lse, gold, pred = _vocab_parallel_terms(env, logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)                   # (B, S)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        pred = None
    nll = lse - gold
    z = torch.square(lse)
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    sharded = env is not None and env.mesh is not None and env.dp > 1
    if sharded:
        batch_group = env.mesh.group(tuple(env.batch_axes))
        count = all_reduce(torch.sum(mask).reshape(1), batch_group)[0]
    else:
        count = torch.sum(mask)
    denom = torch.clamp(count, min=1.0)
    loss = torch.sum(nll * mask) / denom
    zloss = z_loss_coef * torch.sum(z * mask) / denom
    if pred is None:
        pred = torch.argmax(logits, -1)
    metrics = {
        "nll": loss,
        "z_loss": zloss,
        "accuracy": torch.sum((pred == labels) * mask) / denom,
    }
    if sharded:
        parts = all_reduce(torch.stack([m.detach() for m in
                                        metrics.values()]), batch_group)
        metrics = dict(zip(metrics, parts))
    return loss + zloss, metrics
