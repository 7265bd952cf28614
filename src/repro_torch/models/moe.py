"""Expert-parallel Mixture-of-Experts FFN (the reference's ``moe_ffn``,
``repro/models/moe.py``).

Token-choice top-k routing with per-expert capacity and sort-based
dispatch (no (N, E, C) one-hot tensor, which is quadratic in experts):

    tokens (N, D)
      -> fp32 router -> softmax -> top-k (N, k), renormalised
      -> stable sort of the N*k assignments by expert
      -> capacity scatter (E, C, D) -> grouped SwiGLU (``torch.bmm``)
      -> gather + weighted combine -> (N, D)

Capacity is ceil(N * k * capacity_factor / E), at least 1.  An assignment
past its expert's capacity is dropped; the sort is stable, so the earlier
assignment wins.  N counts every row it is given: at decode, every engine
slot, idle ones too, as in the reference.

Weights: ``router`` (E, D) and the optional ``shared`` SwiGLU in the port's
(out, in) layout; the experts' ``wg``/``wu`` (E, D, F) and ``wd`` (E, F, D)
in the reference's (in, out) layout, which ``torch.bmm`` reads as it lies.

Under a mesh with a tp axis the experts split over it (E/tp a rank), as
the reference's ``shard_map`` body runs them, with the collectives issued
through ``distributed/collectives.py``:

* token-parallel (the sequence divides over tp: prefill, a width of 1
  included): each rank routes its own block of the sequence, with the
  capacity from its *local* token count, as the reference does (so drops
  differ from one device's), then an all-to-all sends each expert's rows
  to its rank, the local experts run, an all-to-all brings them back, and
  an all-gather over tp rebuilds the sequence;
* token-replicated (decode): every rank routes all the tokens, runs its
  experts' slice of the dispatch buffer, and an all-reduce sums the
  buffers;
* a tp width of 1 with more than one batch rank: the reference runs no
  ``shard_map`` there, so its routing is global: each rank routes its own
  tokens, an all-gather of the assignments over the batch axes gives every
  rank the global sort and capacity, the rank keeps its own assignments'
  decisions, and the aux loss is the global one (its fractions all-reduced
  over the batch axes).

The ``hybrid_moe`` family (Nemotron-H) has a MoE of its own,
:func:`moe_dropless`, on one device only:

    tokens (N, D)
      -> fp32 router -> sigmoid scores s (N, E); the top-k of s + bias
         choose the experts, s of the chosen (renormalised, times the
         routed scale) weigh them
      -> stable sort of the N*k assignments by expert, each expert's row
         offsets on the device
      -> grouped relu^2 experts over each expert's own rows
         (``kernels/moe_grouped``: CUDA C++ on the card)
      -> weighted sum over each token's k rows + the shared relu^2 expert

No assignment is dropped, and the work follows the N*k rows routed, not
E times a capacity; every shape is fixed by N, so the decode step stays
one CUDA graph.  Its weights: ``router`` (E, D), ``bias`` (E,), ``wu``
(E, D, F) and ``wd`` (E, F, D) as the stacks above, and the shared
expert's ``shared.{wu (Fs, D), wd (D, Fs)}`` in (out, in) layout.

The aux loss is averaged over the batch and tp axes (the reference's
``pmean``); the shared SwiGLU is tensor-parallel like any MLP.  Under
grad the collectives are the differentiable ones of
``distributed/collectives.py``: the rank's block of the sequence is a
``split_to`` and the rebuilt sequence a ``gather_from``, the exchanges
``exchange`` (their own inverse), and the router's gradient is summed over
tp where the tp ranks route different tokens.  Under sequence
parallelism (``layers.seq_parallel``) the rank's tokens are already its
block of the sequence and stay so.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.collectives import (all_gather, all_reduce, copy_to,
                                       exchange, gather_from, reduce_from,
                                       split_to)
from ..kernels.moe_grouped.ops import grouped_relu2
from .common import Env, dense_init, leaf, under, zeros
from .layers import _linear, init_swiglu, seq_parallel, swiglu

Params = Dict[str, Any]


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, num_experts: int,
             shared_experts: int, kw: Dict[str, Any]) -> Params:
    """The reference's distributions; each expert stack is drawn slice by
    slice (``common.DRAW_LIMIT``)."""
    E = num_experts
    p: Params = {
        "router": dense_init(gen, (E, d_model), **leaf(kw, "router")),
        "wg": dense_init(gen, (E, d_model, d_ff), in_axis=-2,
                         **leaf(kw, "wg")),
        "wu": dense_init(gen, (E, d_model, d_ff), in_axis=-2,
                         **leaf(kw, "wu")),
        "wd": dense_init(gen, (E, d_ff, d_model), in_axis=-2,
                         **leaf(kw, "wd")),
    }
    if shared_experts:
        p["shared"] = init_swiglu(gen, d_model, shared_experts * d_ff,
                                  under(kw, "shared"))
    return p


def _route(xf: torch.Tensor, router: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp32 router: (probs (N, E), top_w (N, k) renormalised, top_ids (N, k)
    in descending probability)."""
    logits = F.linear(xf.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_ids = torch.topk(probs, k, dim=-1)
    return probs, top_w / top_w.sum(dim=-1, keepdim=True), top_ids


def _sorted_positions(ids: torch.Tensor, num_experts: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(order, sorted ids, position within its expert) of the assignments
    ``ids`` stably sorted by expert: earlier assignments come first."""
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    # a static-shape count (``bincount`` has no meta kernel for a dry run)
    counts = torch.zeros(num_experts, dtype=ids.dtype,
                         device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(ids.shape[0], device=ids.device) - offsets[sorted_ids]
    return order, sorted_ids, pos


def _dispatch_local(x_flat: torch.Tensor, ids: torch.Tensor, capacity: int,
                    num_experts: int, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort assignments by expert and scatter into an (E, C, D) buffer.

    ``ids`` is token-major (assignment a belongs to token a // k).  Returns
    (buffer, slot_of_assignment, valid): ``slot_of_assignment`` maps each
    assignment, in its original order, to its flat E*C slot, or to the
    overflow slot E*C when dropped.
    """
    nk = ids.shape[0]
    d = x_flat.shape[-1]
    order, sorted_ids, pos = _sorted_positions(ids, num_experts)
    valid_sorted = pos < capacity
    flat_slot_sorted = torch.where(valid_sorted, sorted_ids * capacity + pos,
                                   num_experts * capacity)
    # the overflow row E*C takes every dropped write and is sliced off
    buffer = x_flat.new_zeros((num_experts * capacity + 1, d))
    buffer[flat_slot_sorted] = x_flat[order // k]
    buffer = buffer[:-1].reshape(num_experts, capacity, d)
    # un-sort slot/valid back to assignment order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(nk, device=ids.device)
    return buffer, flat_slot_sorted[inv], valid_sorted[inv]


def _expert_ffn(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor) -> torch.Tensor:
    """Grouped SwiGLU over (E, T, D) with (E, D, F) / (E, F, D) weights."""
    dtype = buf.dtype
    g = torch.bmm(buf, wg.to(dtype))
    u = torch.bmm(buf, wu.to(dtype))
    h = F.silu(g.float()).to(dtype) * u
    return torch.bmm(h, wd.to(dtype))


def _global_valid(env: Env, ids: torch.Tensor, n_global: int, k: int,
                  num_experts: int, capacity_factor: float) -> torch.Tensor:
    """Which of this rank's assignments ``ids`` (token-major) find room
    when the batch ranks' assignments are sorted together, as one device
    routes the global batch: the all-gathered assignments in rank order
    are the global ones in token order."""
    every = all_gather(ids, env.mesh.group(tuple(env.batch_axes)))
    capacity = max(int(math.ceil(n_global * k * capacity_factor
                                 / num_experts)), 1)
    order, _, sorted_pos = _sorted_positions(every, num_experts)
    pos = torch.empty_like(every)
    pos[order] = sorted_pos
    at = env.mesh.index(tuple(env.batch_axes)) * ids.shape[0]
    return pos[at:at + ids.shape[0]] < capacity


def _moe_local(env: Env, x: torch.Tensor, p: Params, *, k: int,
               num_experts: int, capacity_factor: float,
               token_replicated: bool = False, global_batch: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's MoE body (the reference's, run per shard): x (B, S, D)
    its tokens; ``p``'s experts its E/tp.  Returns (y, the Switch
    load-balance aux loss of its tokens).  ``global_batch``: the rank's
    tokens are its block of a batch routed globally (tp 1 under a mesh);
    the aux loss is then the global one."""
    B, S, D = x.shape
    N = B * S
    xf = x.reshape(N, D)
    router = p["router"]
    if env.mesh is not None and not token_replicated and not global_batch:
        router = copy_to(router, env.tp_group)   # tp ranks: other tokens
    probs, top_w, top_ids = _route(xf, router, k)
    ids = top_ids.reshape(-1)                                  # (N*k,)
    if global_batch:
        group = env.mesh.group(tuple(env.batch_axes))
        n_global = N * env.dp
        top1 = all_reduce(F.one_hot(top_ids[:, 0], num_experts).float()
                          .sum(dim=0), group)
        frac_probs = reduce_from(probs.sum(dim=0), group) / n_global
        aux = num_experts * torch.sum(top1 / n_global * frac_probs)
        room = _global_valid(env, ids, n_global, k, num_experts,
                             capacity_factor)
        # the rank's own assignments that found room, in a buffer of its
        # own (an expert's output does not depend on its slot)
        capacity = min(max(int(math.ceil(n_global * k * capacity_factor
                                         / num_experts)), 1), N * k)
        kept = torch.where(room, ids, num_experts)
        buf, slot, valid = _dispatch_local(xf, kept, capacity,
                                           num_experts + 1, k)
        buf = buf[:num_experts]
        valid = valid & room
    else:
        frac_tokens = F.one_hot(top_ids[:, 0],
                                num_experts).float().mean(dim=0)
        aux = num_experts * torch.sum(frac_tokens * probs.mean(dim=0))
        capacity = max(int(math.ceil(N * k * capacity_factor
                                     / num_experts)), 1)
        xd = copy_to(xf, env.tp_group) if token_replicated else xf
        buf, slot, valid = _dispatch_local(xd, ids, capacity, num_experts, k)
    if env.mesh is None or global_batch:
        y_buf = _expert_ffn(buf, p["wg"], p["wu"], p["wd"])
    elif token_replicated:
        # every rank holds every token: run this rank's experts' slice of
        # the buffer; an all-reduce puts the slices together
        e_local = p["wg"].shape[0]
        lo = env.tp_rank * e_local
        mine = _expert_ffn(buf[lo:lo + e_local], p["wg"], p["wu"], p["wd"])
        y_buf = torch.cat([buf.new_zeros((lo,) + buf.shape[1:]), mine,
                           buf.new_zeros((buf.shape[0] - lo - e_local,)
                                         + buf.shape[1:])])
        y_buf = reduce_from(y_buf, env.tp_group)
    else:
        tp, e_local = env.tp, p["wg"].shape[0]
        # (E, C, D) -> (tp, E_l, C, D) -> exchange -> rows for MY experts
        recv = exchange(buf.reshape(tp, e_local, capacity, D), env.tp_group)
        work = recv.transpose(0, 1).reshape(e_local, tp * capacity, D)
        y_work = _expert_ffn(work, p["wg"], p["wu"], p["wd"])
        back = y_work.reshape(e_local, tp, capacity, D).transpose(0, 1)
        y_buf = exchange(back, env.tp_group).reshape(num_experts,
                                                     capacity, D)

    # gather processed assignments and combine with routing weights
    y_flat = y_buf.reshape(num_experts * capacity, D)
    y_assign = torch.where(valid[:, None],
                           y_flat[slot.clamp(max=y_flat.shape[0] - 1)], 0.0)
    y_tok = torch.sum(y_assign.reshape(N, k, D)
                      * top_w.reshape(N, k, 1).to(y_assign.dtype), dim=1)
    return y_tok.reshape(B, S, D), aux


def moe_ffn(env: Env, p: Params, x: torch.Tensor, *, num_experts: int,
            experts_per_token: int, capacity_factor: float = 1.25,
            shared_d_ff: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN sublayer.  Returns (y, load_balance_aux_loss).  The
    expert-parallel width is ``env.tp``; ``shared_d_ff`` is the shared
    SwiGLU's full hidden width (needed under a mesh)."""
    kw = dict(k=experts_per_token, num_experts=num_experts,
              capacity_factor=capacity_factor)
    if env.mesh is None:
        y, aux = _moe_local(env, x, p, **kw)
    elif env.tp == 1 and env.dp > 1:
        y, aux = _moe_local(env, x, p, global_batch=True, **kw)
    else:
        tp = env.tp
        if num_experts % tp:
            raise ValueError(f"{num_experts} experts do not divide over "
                             f"tp {tp}")
        S = x.shape[1]
        # prefill subdivides the sequence over the model axis (GShard);
        # decode (seq 1) replicates tokens and splits by expert rank
        if seq_parallel(env):       # the rank's block of the sequence
            y, aux = _moe_local(env, x, p, **kw)
        elif S % tp == 0:
            y, aux = _moe_local(env, split_to(x, env.tp_group, 1), p, **kw)
            y = gather_from(y, env.tp_group, 1)
        else:
            y, aux = _moe_local(env, x, p, token_replicated=True, **kw)
        axes = tuple(env.batch_axes) + (env.tp_axis,)
        aux = reduce_from(aux.reshape(1), env.mesh.group(axes))[0] \
            / env.mesh.axis_size(axes)
    if "shared" in p:
        y = y + swiglu(env, p["shared"], x, shared_d_ff)
    return y, aux


# ---------------------------------------------------------------------------
# hybrid_moe: sigmoid router with a selection bias, dropless relu^2 experts
# ---------------------------------------------------------------------------

def init_moe_dropless(gen: torch.Generator, d_model: int, d_ff: int,
                      num_experts: int, shared_d_ff: int,
                      kw: Dict[str, Any]) -> Params:
    """Projections as the reference's distributions; the selection bias
    zeros (a trained model's is learned)."""
    E, D = num_experts, d_model
    return {
        "router": dense_init(gen, (E, D), **leaf(kw, "router")),
        "bias": zeros((E,), **leaf(kw, "bias")),
        "wu": dense_init(gen, (E, D, d_ff), in_axis=-2, **leaf(kw, "wu")),
        "wd": dense_init(gen, (E, d_ff, D), in_axis=-2, **leaf(kw, "wd")),
        "shared": {
            "wu": dense_init(gen, (shared_d_ff, D),
                             **leaf(under(kw, "shared"), "wu")),
            "wd": dense_init(gen, (D, shared_d_ff),
                             **leaf(under(kw, "shared"), "wd"))},
    }


def route_sigmoid(xf: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
                  k: int, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights (N, k) fp32, expert ids (N, k)): the top-k of sigmoid(x
    Wr^T) + bias, weighted by their sigmoid scores alone, renormalised and
    times ``scale``."""
    s = torch.sigmoid(F.linear(xf.float(), router.float()))
    ids = torch.topk(s + bias.float(), k, dim=-1).indices
    w = s.gather(1, ids)
    return w / (w.sum(dim=-1, keepdim=True) + 1e-20) * scale, ids


def relu2_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``wd relu(wu x)^2`` with (out, in) weights, the square in fp32."""
    h = torch.relu(_linear(x, p["wu"]).float()).square().to(x.dtype)
    return _linear(h, p["wd"])


def moe_dropless(env: Env, p: Params, x: torch.Tensor, *, num_experts: int,
                 experts_per_token: int, routed_scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``hybrid_moe`` MoE sublayer of x (B, S, D): every token's k
    chosen experts and the shared expert.  Returns (y (B, S, D), the
    chosen experts (B, S, k)).  One device only."""
    if env.mesh is not None:
        raise ValueError("the dropless MoE runs on one device; sharding it "
                         "is not implemented")
    B, S, D = x.shape
    N, k = B * S, experts_per_token
    xf = x.reshape(N, D)
    w, ids = route_sigmoid(xf, p["router"], p["bias"], k, routed_scale)
    flat = ids.reshape(-1)                                   # (N*k,)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(num_experts, dtype=flat.dtype,
                         device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    routed = grouped_relu2(xf, order // k, order, w.reshape(-1)[order],
                           offsets, p["wu"].to(x.dtype), p["wd"].to(x.dtype))
    y = routed.view(N, k, D).sum(dim=1) + relu2_mlp(p["shared"], xf).float()
    return y.to(x.dtype).reshape(B, S, D), ids.view(B, S, k)
