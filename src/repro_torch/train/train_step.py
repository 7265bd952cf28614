"""Train-step factory: fwd + bwd + AdamW, mixed precision, microbatch
gradient accumulation, MoE aux loss.

``TrainState`` is a plain NamedTuple of the fp32 master params and the
AdamW state.  Each step differentiates the loss with respect to a working
copy of the params in ``env.compute_dtype`` (bf16 gradients, as the
reference's), and the optimizer updates the fp32 master.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..models.api import ModelApi
from ..models.common import DeviceLike, Env, resolve_device
from .loss import next_token_loss
from .optimizer import AdamState, AdamWConfig, adamw_init, adamw_update
from .tree import tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any           # fp32 master; the working copy is derived per step
    opt: AdamState


def init_train_state(api: ModelApi, gen: torch.Generator,
                     opt_cfg: AdamWConfig, *,
                     device: DeviceLike = None) -> TrainState:
    """fp32 params drawn from ``gen`` on ``device`` (CUDA unless named)
    and zero AdamW state."""
    params = api.init(gen, device=resolve_device(device), dtype=torch.float32)
    return TrainState(params=params, opt=adamw_init(params, opt_cfg))


def make_loss_fn(api: ModelApi, env: Env, aux_coef: float = 0.01,
                 label_mask_fn: Optional[Callable] = None):
    """``loss_fn(compute_params, batch) -> (total, metrics)`` over the
    low-precision working copy of the params."""
    def loss_fn(compute_params, batch):
        logits, aux = api.forward(env, compute_params, batch)
        mask = label_mask_fn(batch) if label_mask_fn else None
        loss, metrics = next_token_loss(logits, batch["labels"], mask)
        total = loss + aux_coef * aux
        metrics["aux_loss"] = aux
        metrics["loss"] = total
        return total, metrics
    return loss_fn


def _working_copy(params, dtype: torch.dtype):
    """Every floating leaf cast to ``dtype`` as a fresh leaf of the graph
    (detached even where the cast is a no-op and returns the master)."""
    return tree_map(lambda p: p.to(dtype).detach().requires_grad_()
                    if p.is_floating_point() else p, params)


def value_and_grad(loss_fn: Callable, params, batch):
    """((loss, metrics), grads): the gradient of ``loss_fn`` with respect
    to every leaf of ``params`` (zeros where it does not reach one), the
    metrics detached."""
    (loss, metrics) = loss_fn(params, batch)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    it = iter(grads)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_map(lambda _: next(it), params)


def make_train_step(api: ModelApi, env: Env, opt_cfg: AdamWConfig,
                    *, microbatches: int = 1, aux_coef: float = 0.01,
                    label_mask_fn: Optional[Callable] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``, which
    updates ``state``'s tensors in place (``adamw_update``), as the
    reference launcher's ``jit(..., donate_argnums=0)`` hands their buffers
    to the new state.

    With ``microbatches > 1`` the global batch is split on the leading axis
    and gradients accumulate in fp32 over a loop of microbatches (one
    optimizer step at the end; the metrics are their means).
    """
    loss_fn = make_loss_fn(api, env, aux_coef, label_mask_fn)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        working = _working_copy(state.params, env.compute_dtype)
        if microbatches == 1:
            (_, metrics), grads = value_and_grad(loss_fn, working, batch)
        else:
            def split(x, i):
                b = x.shape[0]
                return x.reshape(microbatches, b // microbatches,
                                 *x.shape[1:])[i]
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device),
                             state.params)
            per_mb = []
            for i in range(microbatches):
                mbatch = {k: split(v, i) for k, v in batch.items()}
                (_, m), g = value_and_grad(loss_fn, working, mbatch)
                grads = tree_map(
                    lambda a, b: a + b.to(torch.float32) / microbatches,
                    grads, g)
                del g
                per_mb.append(m)
            metrics = {k: torch.stack([m[k] for m in per_mb]).mean(dim=0)
                       for k in per_mb[0]}
        del working
        new_params, new_opt, opt_metrics = adamw_update(
            grads, state.opt, state.params, opt_cfg)
        metrics.update(opt_metrics)
        return TrainState(new_params, new_opt), metrics

    return train_step
