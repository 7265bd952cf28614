"""Train-step factory: fwd + bwd + AdamW, mixed precision, microbatch
gradient accumulation, MoE aux loss.

``TrainState`` is a plain NamedTuple of the fp32 master params and the
AdamW state.  Each step differentiates the loss with respect to a working
copy of the params in ``env.compute_dtype`` (bf16 gradients, as the
reference's), and the optimizer updates the fp32 master.

Under a mesh (``env.mesh``) each rank holds its shard of the master
params, ``mu`` and ``nu`` (the training layout of
``distributed/sharding.py``: tp and the batch axes, which is ZeRO-3, as
the reference's rules make it), and ``train_step`` takes the *global*
batch, of which each rank runs its block over the batch axes.  The loss is
the global mean (``loss.next_token_loss``), each layer gathers its weights
over the batch axes in its body, whose backward reduce-scatters their
gradients; then :func:`~repro_torch.distributed.sharding.reduce_grads`
completes the replicated leaves' gradients, and AdamW updates every
rank's shard with the global clipping norm.  With ``microbatches = m``
the global batch of ``B`` is split on its leading axis first, as the
reference splits it: microbatch ``i`` is rows ``[i B/m, (i+1) B/m)``, and
batch rank ``d`` of ``dp`` runs rows ``i B/m + d B/(m dp)`` up to
``i B/m + (d+1) B/(m dp)`` of it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..distributed.sharding import local_batch, reduce_grads
from ..models.api import ModelApi
from ..models.common import DeviceLike, Env, resolve_device
from ..models.convert import reference_last_axis
from ..models.layers import vocab_parallel
from .loss import next_token_loss
from .optimizer import (AdamState, AdamWConfig, MeshLayout, adamw_init,
                        adamw_update)
from .tree import tree_leaves, tree_leaves_with_path, tree_map


class TrainState(NamedTuple):
    params: Any           # fp32 master; the working copy is derived per step
    opt: AdamState


def init_train_state(api: ModelApi, gen: torch.Generator,
                     opt_cfg: AdamWConfig, *,
                     device: DeviceLike = None,
                     env: Optional[Env] = None) -> TrainState:
    """fp32 params drawn from ``gen`` on ``device`` (CUDA unless named)
    and zero AdamW state; under ``env``'s mesh, the rank's shard of each
    (the training layout), equal to that part of the one-device draw."""
    params = api.init(gen, device=resolve_device(device), dtype=torch.float32,
                      env=env, fsdp=True)
    layout = MeshLayout.of(api.cfg, env) if env is not None else None
    return TrainState(params=params,
                      opt=adamw_init(params, opt_cfg, layout))


def make_loss_fn(api: ModelApi, env: Env, aux_coef: float = 0.01,
                 label_mask_fn: Optional[Callable] = None):
    """``loss_fn(compute_params, batch) -> (total, metrics)`` over the
    low-precision working copy of the params.  Under a mesh ``batch`` is
    global, ``total`` the rank's share of the loss and the metrics
    global."""
    mesh = env.mesh is not None
    split_vocab = vocab_parallel(env, api.cfg.vocab_size)

    def loss_fn(compute_params, batch):
        logits, aux = api.forward(env, compute_params, batch)
        local = local_batch(env, batch)
        mask = label_mask_fn(local) if label_mask_fn else None
        loss, metrics = next_token_loss(logits, local["labels"], mask,
                                        env=env if mesh else None,
                                        vocab_parallel=split_vocab)
        total = loss + aux_coef * aux
        metrics["aux_loss"] = aux
        metrics["loss"] = (total if not mesh or env.dp == 1 else
                           metrics["nll"] + metrics["z_loss"]
                           + aux_coef * aux.detach())
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
    optimizer step at the end; the metrics are their means).  Under a
    mesh the state is the rank's shard and ``batch`` global (see the
    module's notes).
    """
    loss_fn = make_loss_fn(api, env, aux_coef, label_mask_fn)
    layout = MeshLayout.of(api.cfg, env)

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
        if layout is not None:
            reduce_grads(env, layout.rules, dict(tree_leaves_with_path(grads)))
        new_params, new_opt, opt_metrics = adamw_update(
            grads, state.opt, state.params, opt_cfg, layout)
        metrics.update(opt_metrics)
        return TrainState(new_params, new_opt), metrics

    return train_step


def checkpoint_layout(api: ModelApi, env: Env, opt_cfg: AdamWConfig
                      ) -> Optional[Callable[[str, torch.Tensor],
                                             Tuple[Sequence[int], Tuple]]]:
    """For ``Checkpointer.save(..., layout=...)`` of a ``TrainState`` under
    ``env``'s mesh: ``fn(key, leaf)`` -> (the leaf's global shape, this
    rank's Index), the global shape being the one-device state's (the
    quantized ``nu``'s codes padded along their blocked axis, its scales
    one per block).  ``fn(key, leaf)[1]`` is ``restore``'s ``sharding_fn``
    onto this mesh.  None without a mesh."""
    layout = MeshLayout.of(api.cfg, env)
    if layout is None:
        return None
    block = opt_cfg.quant_block

    def fn(key: str, leaf: torch.Tensor):
        part, _, path = key.partition("/")
        if part == "opt":
            part, _, path = path.partition("/")
        if part == "step":
            return (), ()
        full, index = layout.full[path], layout.rules[path].index
        if part in ("params", "mu") or not opt_cfg.quantize_nu:
            return full, index
        axis = reference_last_axis(path, leaf) % len(full)
        blocks = -(-full[axis] // block)
        shape = list(full)
        if part == "nu":
            shape[axis] = blocks * block
            return tuple(shape), index
        shape[axis] = blocks                                 # nu_scale
        whole = list(index)
        whole[axis] = None
        return tuple(shape), tuple(whole)
    return fn
