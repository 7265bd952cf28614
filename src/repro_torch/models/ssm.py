"""Mamba2 (state-space duality / SSD) blocks.

The chunked SSD algorithm (Dao & Gu 2024): within a chunk the recurrence is
materialized as an attention-like masked product; across chunks a small
recurrent state (H, hd, N) is carried.  A prompt's scan goes to
:func:`repro_torch.kernels.ssd_scan.ops.ssd_scan` (the CUDA kernel on the
card, its plain version on the CPU); this module holds the block plumbing
(projections, depthwise causal conv, gating, the single-token decode
update), in the reference's order of operations and casts.

Two variants beyond the reference's block, both off for its models:
``cfg.ssm_groups`` G > 1 splits B and C into G groups, head h reading
group h // (H / G), in the scan and in the decode update alike; and
``cfg.ssm_gate_first`` gates first, ``y * silu(z)``, then RMS-normalises
each group of d_inner / G channels (Nemotron-H's ``norm_before_gate``
False), where the reference's block normalises all the channels and then
gates.  ``cfg.ssm_heads`` sets the width as heads times head width.

Under a tp mesh (``env.tp_shards`` of the SSD heads) each rank keeps its
block of heads, split by structure (``distributed/sharding.py``): its
heads' rows of ``z``, ``x`` and ``dt`` in ``in_proj`` and all of ``B`` and
``C`` (one group, shared by every head), the conv over its ``x`` channels
and all of ``B`` and ``C``.  The SSD kernel runs on the local heads; the
gated RMS norm sums its squares over tp with one all-reduce, and the
row-parallel ``out_proj`` ends in another.  In a training backward the
block's input and the summed squares take the all-reduce of their
gradients that the ranks' heads each add a part to (``layers.tp_enter``,
``collectives.copy_to``); the replicated ``B``/``C`` rows sum their
gradients by the rule of ``distributed/sharding.py``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.collectives import copy_to, reduce_from
from ..kernels.ssd_scan.ops import ssd_scan
from .common import Env, const, dense_init, leaf, ones, zeros
from .layers import _linear, rms_norm, tp_enter, tp_exit

Params = Dict[str, Any]


def ssm_dims(d_model: int, expand: int, head_dim: int, n_state: int,
             conv_width: int, *, groups: int = 1, d_inner: int = 0
             ) -> Dict[str, int]:
    """``d_inner``: the width where given (heads times head width), else
    ``expand * d_model``; ``groups`` of B and C."""
    d_inner = d_inner or expand * d_model
    nheads = d_inner // head_dim
    d_conv = d_inner + 2 * groups * n_state  # x, B, C go through the conv
    return dict(d_inner=d_inner, nheads=nheads, d_conv=d_conv,
                conv_width=conv_width, n_state=n_state, head_dim=head_dim,
                groups=groups)


def cfg_dims(cfg) -> Dict[str, int]:
    """:func:`ssm_dims` of ``cfg``'s Mamba2 layers."""
    return ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim,
                    cfg.ssm_state, cfg.ssm_conv_width, groups=cfg.ssm_groups,
                    d_inner=cfg.ssm_inner)


def init_ssm(gen: torch.Generator, cfg, kw: Dict[str, Any]) -> Params:
    """A Mamba2 block of ``cfg`` (:func:`cfg_dims`) with the reference's
    distributions; ``in_proj``/``out_proj`` in (out, in) layout for
    ``F.linear``, ``conv_w`` (W, d_conv) as the reference.  ``kw``: the
    ``device``/``dtype`` (and a rank's shard, ``common.leaf``)."""
    dims = cfg_dims(cfg)
    D, d_in, H = cfg.d_model, dims["d_inner"], dims["nheads"]
    device = kw["device"]
    in_proj = dense_init(
        gen, (2 * d_in + 2 * dims["groups"] * dims["n_state"] + H, D),
        **leaf(kw, "in_proj"))
    out_proj = dense_init(gen, (D, d_in), **leaf(kw, "out_proj"))
    conv_w = dense_init(gen, (dims["conv_width"], dims["d_conv"]), in_axis=0,
                        **leaf(kw, "conv_w"))
    u = torch.rand((H,), generator=gen, dtype=torch.float32,
                   device=gen.device).to(device)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": zeros((dims["d_conv"],), **leaf(kw, "conv_b")),
        "A_log": const(torch.log(torch.linspace(1.0, 16.0, H,
                                                device=device)),
                       **leaf(kw, "A_log")),
        "D": ones((H,), **leaf(kw, "D")),
        "dt_bias": const(torch.log(torch.expm1(dt)), **leaf(kw, "dt_bias")),
        "norm": zeros((d_in,), **leaf(kw, "norm")),
        "out_proj": out_proj,
    }


def _depthwise_causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           state: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv over (B, S, C) with kernel (W, C), written as
    the reference's shifted sum over the W taps (not ``F.conv1d``: cuDNN
    would run an fp32 convolution in TF32).

    ``state``: (B, W-1, C) history for streaming; returns (y, new_state).
    """
    Bt, S, Cch = x.shape
    W = w.shape[0]
    if state is None:
        state = torch.zeros((Bt, W - 1, Cch), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)          # (B, S+W-1, C)
    # sum_w x[s + w] * k[w]  (causal: window ending at s)
    y = torch.zeros_like(x)
    for i in range(W):
        y = y + xp[:, i:i + S, :] * w[i].to(x.dtype)
    y = y + b.to(x.dtype)
    new_state = xp[:, S:, :] if W > 1 else state
    return y, new_state


def ssm_block(env: Env, p: Params, x: torch.Tensor, cfg, *,
              cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One Mamba2 block (no outer norm/residual).

    cache = (ssm_state (B,H,hd,N) fp32, conv_state (B,W-1,Cconv)) for
    decoding; None for prefill (returns the fresh cache so prefill can
    serve).  A single token against a cache takes the recurrent update;
    anything longer goes through the SSD scan.
    """
    dims = cfg_dims(cfg)
    d_full, H, hd, N, G = (dims["d_inner"], dims["nheads"], dims["head_dim"],
                           dims["n_state"], dims["groups"])
    shard = env.tp_shards(H)
    if shard:                                 # this rank's block of heads
        H //= env.tp
    x = tp_enter(env, x, shard)
    d_in = H * hd
    Bt, S, _ = x.shape
    proj = _linear(x, p["in_proj"])
    z, xin, Bmat, Cmat, dt = torch.split(proj, [d_in, d_in, G * N, G * N, H],
                                         dim=-1)
    conv_in = torch.cat([xin, Bmat, Cmat], dim=-1)
    conv_state = cache[1] if cache is not None else None
    conv_out, new_conv_state = _depthwise_causal_conv(
        conv_in, p["conv_w"], p["conv_b"], conv_state)
    conv_out = F.silu(conv_out.float()).to(x.dtype)
    xin, Bmat, Cmat = torch.split(conv_out, [d_in, G * N, G * N], dim=-1)
    if G > 1:                                 # (B, S, G, N): head h, group h // (H / G)
        Bmat = Bmat.reshape(Bt, S, G, N)
        Cmat = Cmat.reshape(Bt, S, G, N)
    xh = xin.reshape(Bt, S, H, hd)
    A = -torch.exp(p["A_log"].float())                          # (H,)
    dt = F.softplus(dt.float() + p["dt_bias"].float())          # (B,S,H)

    if cache is None or S > 1:
        init_state = cache[0] if cache is not None else None
        y, final_state = ssd_scan(xh, dt, A, Bmat, Cmat, chunk=cfg.ssm_chunk,
                                  init_state=init_state)
    else:
        # single-token decode: state' = exp(dt*A)*state + dt*B (x)
        state = cache[0]                                        # (B,H,hd,N)
        dt1 = dt[:, 0]                                          # (B,H)
        dA = torch.exp(dt1 * A[None, :])                        # (B,H)
        Bn, Cn, bc = Bmat[:, 0].float(), Cmat[:, 0].float(), "bn"
        if G > 1:                             # each head's group: (B,H,N)
            Bn = Bn.repeat_interleave(H // G, dim=1)
            Cn, bc = Cn.repeat_interleave(H // G, dim=1), "bhn"
        xB = torch.einsum(f"bhp,{bc}->bhpn", xh[:, 0].float(), Bn)
        final_state = (dA[:, :, None, None] * state
                       + dt1[:, :, None, None] * xB)
        y = torch.einsum(f"bhpn,{bc}->bhp", final_state, Cn)
        y = y[:, None].to(x.dtype)                              # (B,1,H,hd)
    y = y + xh * p["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(Bt, S, d_in)
    if cfg.ssm_gate_first:
        y = _gated_group_norm(y, z, p["norm"], G, cfg.norm_eps)
    else:
        if shard:
            y = _rms_norm_over_tp(env, y, p["norm"], d_full, cfg.norm_eps)
        else:
            y = rms_norm(y, p["norm"], cfg.norm_eps)
        y = y * F.silu(z.float()).to(x.dtype)
    out = tp_exit(env, _linear(y, p["out_proj"]), shard)
    return out, (final_state, new_conv_state)


def _gated_group_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                      groups: int, eps: float) -> torch.Tensor:
    """``y * silu(z)``, then an RMS norm over each of ``groups`` equal runs
    of channels with the (1 + scale) gain, in fp32 (Nemotron-H's gated
    norm, ``norm_before_gate`` False)."""
    g = y.float() * F.silu(z.float())
    gs = g.reshape(*g.shape[:-1], groups, -1)
    gs = gs * torch.rsqrt(gs.square().mean(dim=-1, keepdim=True) + eps)
    return (gs.reshape(g.shape) * (1.0 + scale.float())).to(y.dtype)


def _rms_norm_over_tp(env: Env, y: torch.Tensor, scale: torch.Tensor,
                      width: int, eps: float) -> torch.Tensor:
    """``layers.rms_norm`` of a row split over tp: each rank's channels of
    the full ``width``, its squares summed by an all-reduce."""
    yf = y.float()
    # every rank's channels read the sum: its gradient is summed too
    sq = copy_to(reduce_from(yf.square().sum(dim=-1, keepdim=True),
                             env.tp_group), env.tp_group)
    out = yf * torch.rsqrt(sq / width + eps)
    return (out * (1.0 + scale.float())).to(y.dtype)
