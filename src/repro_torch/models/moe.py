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
  buffers.

The aux loss is averaged over the batch and tp axes (the reference's
``pmean``); the shared SwiGLU is tensor-parallel like any MLP.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.collectives import all_gather, all_reduce, all_to_all
from .common import Env, dense_init, leaf, under
from .layers import init_swiglu, swiglu

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
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    counts = torch.bincount(ids, minlength=num_experts)
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(nk, device=ids.device) - offsets[sorted_ids]
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


def _moe_local(env: Env, x: torch.Tensor, p: Params, *, k: int,
               num_experts: int, capacity_factor: float,
               token_replicated: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's MoE body (the reference's, run per shard): x (B, S, D)
    its tokens; ``p``'s experts its E/tp.  Returns (y, the Switch
    load-balance aux loss of its tokens)."""
    B, S, D = x.shape
    N = B * S
    xf = x.reshape(N, D)
    probs, top_w, top_ids = _route(xf, p["router"], k)
    frac_tokens = F.one_hot(top_ids[:, 0], num_experts).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = num_experts * torch.sum(frac_tokens * frac_probs)

    ids = top_ids.reshape(-1)                                  # (N*k,)
    capacity = max(int(math.ceil(N * k * capacity_factor / num_experts)), 1)
    buf, slot, valid = _dispatch_local(xf, ids, capacity, num_experts, k)
    if env.mesh is None:
        y_buf = _expert_ffn(buf, p["wg"], p["wu"], p["wd"])
    elif token_replicated:
        # every rank holds every token: run this rank's experts' slice of
        # the buffer; an all-reduce puts the slices together
        e_local = p["wg"].shape[0]
        lo = env.tp_rank * e_local
        y_buf = torch.zeros_like(buf)
        y_buf[lo:lo + e_local] = _expert_ffn(buf[lo:lo + e_local], p["wg"],
                                             p["wu"], p["wd"])
        y_buf = all_reduce(y_buf, env.tp_group)
    else:
        tp, e_local = env.tp, p["wg"].shape[0]
        # (E, C, D) -> (tp, E_l, C, D) -> exchange -> rows for MY experts
        recv = all_to_all(buf.reshape(tp, e_local, capacity, D),
                          env.tp_group)
        work = recv.transpose(0, 1).reshape(e_local, tp * capacity, D)
        y_work = _expert_ffn(work, p["wg"], p["wu"], p["wd"])
        back = y_work.reshape(e_local, tp, capacity, D).transpose(0, 1)
        y_buf = all_to_all(back, env.tp_group).reshape(num_experts,
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
    else:
        tp, r = env.tp, env.tp_rank
        if num_experts % tp:
            raise ValueError(f"{num_experts} experts do not divide over "
                             f"tp {tp}")
        S = x.shape[1]
        # prefill subdivides the sequence over the model axis (GShard);
        # decode (seq 1) replicates tokens and splits by expert rank
        token_parallel = S % tp == 0
        if token_parallel:
            s_l = S // tp
            y, aux = _moe_local(env, x[:, r * s_l:(r + 1) * s_l], p, **kw)
            y = all_gather(y, env.tp_group, dim=1)
        else:
            y, aux = _moe_local(env, x, p, token_replicated=True, **kw)
        axes = tuple(env.batch_axes) + (env.tp_axis,)
        aux = all_reduce(aux.reshape(1).clone(),
                         env.mesh.group(axes))[0] / env.mesh.axis_size(axes)
    if "shared" in p:
        y = y + swiglu(env, p["shared"], x, shared_d_ff)
    return y, aux
