"""Optimizer: AdamW with mixed-precision state, schedules (cosine + WSD),
gradient clipping, and optional int8 second-moment quantization.

Implemented from scratch over the port's parameter trees (nested dicts and
lists of tensors, :mod:`.tree`), in the reference's float32 arithmetic: the
step count, ``b ** step`` and the schedules are float32 tensors.

The quantized second moment is blocked along the axis that is the last one
of the reference's layout (:func:`repro_torch.models.convert.reference_last_axis`):
dim 0 of a projection the port stores as (out, in), the last axis of every
other leaf.  So one block holds the same elements in both packages, and the
int8 codes and per-block scales carry across with the params' transposition.

``adamw_update`` writes the new params and moments into the old tensors,
leaf by leaf, as the reference launcher's ``jit`` with donated state
reuses their buffers: a model's fp32 state is not held twice.

Under a mesh (a :class:`MeshLayout`) every rank updates its shard of the
params and moments (ZeRO-3: the state is laid out as the params, which the
rules split over tp and over the batch axes).  The clipping norm stays
global: each rank sums the squares of the elements it owns (a replicated
element is counted on one of the ranks holding it,
``sharding.owned_mask``), then one all-reduce over every rank.  The
quantized second moment keeps the reference's global blocks: where a
rank holds a part of the blocked axis (split over tp or the batch axes,
even in pieces that are not whole, aligned blocks), each block's maximum
is the MAX all-reduce of the ranks' partial maxima over the group that
splits the axis; the rank keeps the codes of its own elements and the
scale of every block of the axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..distributed.collectives import all_reduce
from ..distributed.sharding import GradRule, grad_rule, owned_mask
from ..models.common import full_shapes
from ..models.convert import reference_last_axis
from .tree import tree_leaves, tree_leaves_with_path, tree_map, \
    tree_map_with_path

Params = Any


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------

def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * torch.clamp(step / max(1, warmup), max=1.0)
        t = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def wsd_schedule(base_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1, min_frac: float = 0.01
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Warmup-Stable-Decay (minicpm): linear warmup, long stable plateau,
    sharp decay over the final ``decay_frac`` of training."""
    decay_steps = max(1, int(total * decay_frac))
    stable_end = total - decay_steps

    def lr(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * torch.clamp(step / max(1, warmup), max=1.0)
        t = torch.clamp((step - stable_end) / decay_steps, 0.0, 1.0)
        decay = base_lr * (min_frac ** t)   # exponential anneal
        plateau = torch.full_like(step, base_lr)
        return torch.where(step < warmup, warm,
                           torch.where(step < stable_end, plateau, decay))
    return lr


def get_schedule(name: str, base_lr: float, warmup: int, total: int
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "wsd":
        return wsd_schedule(base_lr, warmup, total)
    return cosine_schedule(base_lr, warmup, total)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    step: torch.Tensor    # int32 scalar
    mu: Params            # first moment (fp32 or bf16)
    nu: Params            # second moment (fp32, or int8-quantized blocks)
    nu_scale: Optional[Params]  # per-block scales when quantized


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: str = "cosine"
    warmup: int = 100
    total_steps: int = 10000
    quantize_nu: bool = False     # int8 block-quantized second moment
    quant_block: int = 256
    mu_dtype: torch.dtype = torch.float32   # bf16 halves first-moment memory


def _quantize_blocks(x: torch.Tensor, block: int, axis: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block int8 quantization of a non-negative tensor along ``axis``
    only: returns the codes (``axis`` padded to a multiple of ``block``)
    and one fp32 scale per block (``axis`` holding the block index)."""
    x = x.movedim(axis, -1)
    last = x.shape[-1]
    pad = (-last) % block
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    nb = (last + pad) // block
    blocks = x.reshape(*x.shape[:-1], nb, block)
    scale = torch.amax(blocks, dim=-1, keepdim=True) / 127.0 + 1e-30
    q = torch.clamp(torch.round(blocks / scale), 0, 127).to(torch.int8)
    return (q.reshape(*x.shape[:-1], nb * block).movedim(-1, axis),
            scale[..., 0].movedim(-1, axis))


def _dequantize_blocks(q: torch.Tensor, scale: torch.Tensor, shape,
                       block: int, axis: int) -> torch.Tensor:
    q, scale = q.movedim(axis, -1), scale.movedim(axis, -1)
    nb = scale.shape[-1]
    blocks = q.reshape(*q.shape[:-1], nb, block).to(torch.float32)
    deq = blocks * scale[..., None]
    deq = deq.reshape(*q.shape[:-1], nb * block)[..., :shape[axis]]
    return deq.movedim(-1, axis)


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A model's params on one rank of a mesh: every leaf's gradient rule
    (``distributed/sharding.py``) and full shape, by path."""

    env: Any
    rules: Dict[str, GradRule]
    full: Dict[str, Tuple[int, ...]]

    @classmethod
    def of(cls, cfg, env) -> Optional["MeshLayout"]:
        """The layout of ``cfg``'s params on ``env``'s rank; None without
        a mesh."""
        if env.mesh is None:
            return None
        full = full_shapes(cfg)
        return cls(env, {path: grad_rule(cfg, env, path, shape)
                         for path, shape in full.items()}, full)

    def split_axis(self, path: str, axis: int):
        """(global positions, full size, group) of the rank's elements
        along ``axis`` of the leaf at ``path`` where the rank holds only
        part of it; None where it holds it whole."""
        rule = self.rules[path]
        axis = axis % len(rule.index)
        positions = rule.index[axis]
        if positions is None:
            return None
        mesh = self.env.mesh
        group = (mesh.group(tuple(self.env.batch_axes))
                 if axis == rule.fsdp_dim else self.env.tp_group)
        return positions, self.full[path][axis], group


def _quantize_split(x: torch.Tensor, block: int, axis: int, split
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_quantize_blocks` of a rank's part of a tensor whose blocked
    ``axis`` it holds only in part: ``split`` = (global positions of its
    elements along the axis, the axis's full size, the group that splits
    it).  Returns the codes of its elements (unpadded) and the scale of
    every global block (the axis holding the block index)."""
    positions, full, group = split
    x = x.movedim(axis, -1)
    blk = (positions // block).to(x.device)
    nb = -(-full // block)
    peak = x.new_zeros(tuple(x.shape[:-1]) + (nb,)).scatter_reduce(
        -1, blk.expand(x.shape), x, "amax", include_self=True)
    peak = all_reduce(peak.contiguous(), group, op="max")
    scale = peak / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale.index_select(-1, blk)), 0,
                    127).to(torch.int8)
    return q.movedim(-1, axis), scale.movedim(-1, axis)


def _dequantize_split(q: torch.Tensor, scale: torch.Tensor, block: int,
                      axis: int, split) -> torch.Tensor:
    blk = (split[0] // block).to(q.device)
    deq = q.movedim(axis, -1).to(torch.float32) * \
        scale.movedim(axis, -1).index_select(-1, blk)
    return deq.movedim(-1, axis)


def _quantize(x: torch.Tensor, block: int, axis: int, split):
    return (_quantize_blocks(x, block, axis) if split is None else
            _quantize_split(x, block, axis, split))


def _split(layout: Optional[MeshLayout], path: str, p: torch.Tensor):
    return None if layout is None else \
        layout.split_axis(path, reference_last_axis(path, p))


def adamw_init(params: Params, cfg: AdamWConfig,
               layout: Optional[MeshLayout] = None) -> AdamState:
    """Zero moments laid out as ``params`` (under ``layout``'s mesh, the
    rank's shard)."""
    mu = tree_map(lambda p: torch.zeros_like(p, dtype=cfg.mu_dtype), params)
    if cfg.quantize_nu:
        def zero_blocks(part):
            return lambda path, p: _quantize(
                torch.zeros_like(p, dtype=torch.float32), cfg.quant_block,
                reference_last_axis(path, p), _split(layout, path, p))[part]
        nu = tree_map_with_path(zero_blocks(0), params)
        nu_scale = tree_map_with_path(zero_blocks(1), params)
    else:
        nu = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params)
        nu_scale = None
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return AdamState(step, mu, nu, nu_scale)


def global_norm(tree: Params,
                layout: Optional[MeshLayout] = None) -> torch.Tensor:
    """The L2 norm of every leaf; under ``layout``'s mesh, of the global
    tree, each element counted once."""
    if layout is None:
        leaves = [torch.sum(torch.square(x.to(torch.float32)))
                  for x in tree_leaves(tree)]
        return torch.sqrt(torch.sum(torch.stack(leaves)))
    leaves = []
    for path, x in tree_leaves_with_path(tree):
        sq = torch.square(x.to(torch.float32))
        mask = owned_mask(layout.rules[path], x)
        leaves.append(torch.sum(sq if mask is None else sq * mask))
    env = layout.env
    total = torch.sum(torch.stack(leaves)).reshape(1)
    total = all_reduce(total, env.mesh.group(env.mesh.axis_names))[0]
    return torch.sqrt(total)


def adamw_update(grads: Params, state: AdamState, params: Params,
                 cfg: AdamWConfig, layout: Optional[MeshLayout] = None
                 ) -> Tuple[Params, AdamState, Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new_params, new_state, metrics): the new
    values are written into the tensors of ``params`` and ``state``, one
    leaf at a time, and those are returned (with a new ``step``).
    ``layout``: the mesh's, where the tensors are the rank's shards."""
    step = state.step + 1
    sched = get_schedule(cfg.schedule, cfg.lr, cfg.warmup, cfg.total_steps)
    lr = sched(step)

    gnorm = global_norm(grads, layout)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step_f = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** step_f
    b2c = 1 - cfg.b2 ** step_f

    flat_s = (tree_leaves(state.nu_scale) if cfg.quantize_nu
              else [None] * len(tree_leaves(params)))
    # leaf by leaf: one leaf's fp32 temporaries live at a time
    for (path, p), g, m, v, s in zip(tree_leaves_with_path(params),
                                     tree_leaves(grads),
                                     tree_leaves(state.mu),
                                     tree_leaves(state.nu), flat_s):
        g = g.to(torch.float32) * scale
        m2 = (cfg.b1 * m.to(torch.float32)
              + (1 - cfg.b1) * g).to(cfg.mu_dtype)
        if cfg.quantize_nu:
            axis = reference_last_axis(path, p)
            split = _split(layout, path, p)
            nu = (_dequantize_blocks(v, s, p.shape, cfg.quant_block, axis)
                  if split is None else
                  _dequantize_split(v, s, cfg.quant_block, axis, split))
            nu = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g)
            v2, s2 = _quantize(nu, cfg.quant_block, axis, split)
        else:
            nu = v2 = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
            s2 = None
        del g
        update = (m2.to(torch.float32) / b1c) / (torch.sqrt(nu / b2c)
                                                 + cfg.eps)
        update = update + cfg.weight_decay * p.to(torch.float32)
        p2 = (p.to(torch.float32) - lr * update).to(p.dtype)
        del update, nu
        for old, new in ((p, p2), (m, m2), (v, v2), (s, s2)):
            if new is not None:
                old.copy_(new)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, state._replace(step=step), metrics
