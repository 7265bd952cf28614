"""Decoder LM: the dense, moe, vlm, ssm and hybrid families.

* dense, vlm : pre-norm GQA attention + SwiGLU per layer; vlm's prefill
               takes ``patch_embeds`` in place of its first embeddings
* moe        : pre-norm GQA attention + the MoE FFN (``models/moe.py``)
* ssm        : Mamba2 (SSD) block per layer (mamba2-370m)
* hybrid     : Mamba2 backbone + ONE weight-shared attention+SwiGLU block
               applied after every ``attn_period``-th layer (zamba2)
* hybrid_moe : one pre-norm mixer a layer, ``x + mixer(norm(x))``, its kind
               by ``cfg.layer_pattern``: M a Mamba2 block (grouped B/C,
               gate-first norm), E the dropless MoE (``moe.moe_dropless``),
               * GQA attention without RoPE (Nemotron-H); one device only

Entry points:

* ``init(cfg, gen, *, device, dtype)``            -> params
* ``forward(env, cfg, params, batch)``            -> (logits, aux)  [train]
* ``prefill(env, cfg, params, batch, max_len)``   -> (logits, cache)
* ``decode_step(env, cfg, params, cache, batch)`` -> (logits, cache)
* ``init_cache(cfg, batch, max_len, env, dtype)`` -> cache

Params: ``embed`` (V, D), ``blocks`` — a list with one dict per layer
(dense, vlm: ``ln1``, ``ln2``, ``attn.{wq,wk,wv,wo}``, ``mlp.{wg,wu,wd}``;
moe: ``moe.{router,wg,wu,wd[,shared]}`` in place of ``mlp``; ssm and
hybrid: ``ln1``, ``ssm.{in_proj,conv_w,conv_b,A_log,D,dt_bias,norm,
out_proj}``; hybrid_moe: ``ln1`` and one of ``ssm``, ``moe.{router,bias,
wu,wd,shared.{wu,wd}}`` or ``attn``), the hybrid's ``shared``
attention+MLP block, ``final_norm``
and, untied, ``head`` (V, D); projections in (out, in) layout.  The layer
stack is a Python loop; the training ``forward`` checkpoints each layer body
when ``env.remat``.  The audio family is ``models/encdec.py``'s.

Under a mesh (``env.mesh``) every entry point works on this rank's shard:
``init(..., env=env)`` draws only the rank's part of each leaf
(``distributed/sharding.py`` ``local_index``; with ``fsdp=True`` the
training layout, also split over the batch axes), equal to the same part
of the one-device init; ``init_cache`` allocates the rank's part of each
entry (the counterpart of the reference's ``shard_cache``); ``prefill`` and
``decode_step`` take the global batch and serving's layout, run the rank's
part of the batch over the batch axes, and return the rank's logits (the
whole vocabulary) and cache.  ``forward`` takes the global batch and the
training layout: each layer's body all-gathers its weights over the batch
axes (``common.fsdp_gather``), and it returns the rank's logits, split
over tp by vocabulary where ``layers.vocab_parallel`` says so, for the
loss's vocab-parallel softmax.  With ``env.seq_shard_activations`` (and a
sequence that divides tp) the residual stream between sublayers is the
rank's block of the sequence.

``prefill`` and ``decode_step`` open ``repro_torch.obs`` spans (recorded
only while tracing is enabled): ``model.cache_init`` around the prefill's
cache, one ``block.attn_ffn``, ``block.ssm``, ``block.shared``,
``block.moe`` (attribute ``rows``: tokens x experts a token) or
``block.attn`` a layer (its cache writes included; the order gives the
index) and ``model.logits``.  ``forward`` opens none.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..distributed.collectives import split_to
from ..distributed.sharding import local_batch, local_cache_index, local_index
from ..obs.trace import span as _obs_span
from .common import (Env, dense_init, embed_init, fsdp_gather, layer_call,
                     leaf, resolve_device, under, zeros)
from .layers import (attention_block, embed, init_attention, init_swiglu,
                     lm_head, replicated_weight, rms_norm, swiglu)
from .moe import init_moe, init_moe_dropless, moe_dropless, moe_ffn
from .ssm import cfg_dims, init_ssm, ssm_block

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]

_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "hybrid_moe")
_SSM_FAMILIES = ("ssm", "hybrid")


def _check_family(cfg: ModelConfig, env: Optional[Env] = None) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"family {cfg.family!r} ({cfg.name}) is not "
                         "handled by transformer.py (audio: models/encdec.py)")
    if cfg.family == "hybrid_moe" and env is not None and \
            env.mesh is not None:
        raise ValueError(f"{cfg.name}: the hybrid_moe family runs on one "
                         "device; sharding it over a mesh is not implemented")


def _kind_index(cfg: ModelConfig) -> Tuple[Tuple[str, int], ...]:
    """hybrid_moe: each layer's kind and its index among the layers of its
    kind (its row of the cache: ``state``/``conv`` for M, ``k``/``v`` for
    *)."""
    pat = cfg.layer_pattern
    return tuple((kind, pat[:i].count(kind)) for i, kind in enumerate(pat))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_attn_ffn(cfg: ModelConfig, gen: torch.Generator,
                   kw: Dict[str, Any]) -> Params:
    """A pre-norm attention + FFN block: every dense, vlm and moe layer, and
    the hybrid's shared block."""
    D = cfg.d_model
    p: Params = {"ln1": zeros((D,), **leaf(kw, "ln1")),
                 "attn": init_attention(gen, D, cfg.num_heads,
                                        cfg.num_kv_heads, cfg.head_dim,
                                        cfg.qkv_bias, under(kw, "attn")),
                 "ln2": zeros((D,), **leaf(kw, "ln2"))}
    if cfg.family == "moe":
        p["moe"] = init_moe(gen, D, cfg.d_ff, cfg.num_experts,
                            cfg.shared_experts, under(kw, "moe"))
    else:
        p["mlp"] = init_swiglu(gen, D, cfg.d_ff, under(kw, "mlp"))
    return p


def _init_pattern_layer(cfg: ModelConfig, gen: torch.Generator,
                        kw: Dict[str, Any], kind: str) -> Params:
    """A hybrid_moe layer: its norm and its mixer of ``kind``."""
    D = cfg.d_model
    p: Params = {"ln1": zeros((D,), **leaf(kw, "ln1"))}
    if kind == "M":
        p["ssm"] = init_ssm(gen, D, expand=cfg.ssm_expand,
                            head_dim=cfg.ssm_head_dim, n_state=cfg.ssm_state,
                            conv_width=cfg.ssm_conv_width,
                            kw=under(kw, "ssm"), groups=cfg.ssm_groups,
                            d_inner=cfg.ssm_inner)
    elif kind == "E":
        p["moe"] = init_moe_dropless(gen, D, cfg.d_ff, cfg.num_experts,
                                     cfg.shared_width, under(kw, "moe"))
    else:
        p["attn"] = init_attention(gen, D, cfg.num_heads, cfg.num_kv_heads,
                                   cfg.head_dim, cfg.qkv_bias,
                                   under(kw, "attn"))
    return p


def shard_kw(cfg: ModelConfig, env: Optional[Env], device: torch.device,
             dtype: torch.dtype, fsdp: bool = False) -> Dict[str, Any]:
    """An initializer's keywords: under a mesh, with the rank's
    ``local_index`` of every leaf (``common.leaf``); ``fsdp``: the
    training layout (also split over the batch axes)."""
    kw: Dict[str, Any] = dict(device=device, dtype=dtype)
    if env is not None and env.mesh is not None:
        batch = tuple(env.batch_axes) if fsdp else ()
        kw.update(prefix="", shard=lambda path, shape: local_index(
            cfg, env.mesh, path, shape, batch_axes=batch))
    return kw


def init(cfg: ModelConfig, gen: torch.Generator, *,
         device: Optional[torch.device] = None,
         dtype: torch.dtype = torch.float32,
         env: Optional[Env] = None, fsdp: bool = False) -> Params:
    """Random weights from ``gen`` with the reference's distributions:
    truncated normal / sqrt(fan_in) for projections, normal x 0.02 for the
    embedding, zeros for the (1 + scale) norm gains, the reference's
    ``A_log``/``D``/``dt_bias`` for Mamba2 blocks.  Under ``env``'s mesh,
    only this rank's shard of each leaf is drawn (with ``fsdp``, the
    training layout's)."""
    _check_family(cfg, env)
    dev = resolve_device(device)
    D, V = cfg.d_model, cfg.vocab_size
    kw = shard_kw(cfg, env, dev, dtype, fsdp)
    p: Params = {"embed": embed_init(gen, (V, D), **leaf(kw, "embed")),
                 "blocks": []}
    for i in range(cfg.num_layers):
        bkw = under(kw, f"blocks/{i}")
        if cfg.family == "hybrid_moe":
            p["blocks"].append(_init_pattern_layer(cfg, gen, bkw,
                                                   cfg.layer_pattern[i]))
        elif cfg.family in _SSM_FAMILIES:
            p["blocks"].append({"ln1": zeros((D,), **leaf(bkw, "ln1")),
                                "ssm": init_ssm(
                gen, D, expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
                n_state=cfg.ssm_state, conv_width=cfg.ssm_conv_width,
                kw=under(bkw, "ssm"))})
        else:
            p["blocks"].append(_init_attn_ffn(cfg, gen, bkw))
    if cfg.family == "hybrid":
        p["shared"] = _init_attn_ffn(cfg, gen, under(kw, "shared"))
    p["final_norm"] = zeros((D,), **leaf(kw, "final_norm"))
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (V, D), **leaf(kw, "head"))
    return p


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _attn_ffn_block(env: Env, cfg: ModelConfig, bp: Params, x: torch.Tensor,
                    positions: torch.Tensor, *,
                    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    kv_len: Optional[torch.Tensor] = None):
    """Pre-norm attention + FFN: a dense, vlm or moe layer, or zamba2's
    weight-shared block (the reference's ``_shared_block``).  Returns
    (x, aux, new_kv): ``aux`` is the MoE layer's load-balance loss (None
    for a SwiGLU block), which serving drops and ``forward`` averages."""
    h = rms_norm(x, replicated_weight(env, bp["ln1"]), cfg.norm_eps)
    a, new_kv = attention_block(
        env, bp["attn"], h, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, positions=positions,
        kv_cache=kv_cache, kv_len=kv_len)
    x = x + a
    h = rms_norm(x, replicated_weight(env, bp["ln2"]), cfg.norm_eps)
    if cfg.family == "moe":
        f, aux = moe_ffn(env, bp["moe"], h, num_experts=cfg.num_experts,
                         experts_per_token=cfg.experts_per_token,
                         capacity_factor=cfg.moe_capacity,
                         shared_d_ff=cfg.shared_experts * cfg.d_ff)
    else:
        f, aux = swiglu(env, bp["mlp"], h, cfg.d_ff), None
    return x + f, aux, new_kv


def _pattern_layer(env: Env, cfg: ModelConfig, bp: Params, kind: str,
                   x: torch.Tensor, positions: torch.Tensor, *,
                   cache: Optional[Cache] = None, at: int = 0,
                   kv_len: Optional[torch.Tensor] = None):
    """One hybrid_moe layer, ``x + mixer(rms_norm(x))``.  ``cache`` (decode):
    the model's cache, this layer's row ``at`` of its kind updated in
    place.  Returns (x, new cache entries: (state, conv) for M, (k, v)
    for *, the chosen experts (B, S, k) for E)."""
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    if kind == "M":
        st = None if cache is None else (cache["state"][at],
                                         cache["conv"][at])
        out, new = ssm_block(env, bp["ssm"], h, cfg, cache=st)
    elif kind == "E":
        out, new = moe_dropless(
            env, bp["moe"], h, num_experts=cfg.num_experts,
            experts_per_token=cfg.experts_per_token,
            routed_scale=cfg.routed_scale)
    else:
        kv = None if cache is None else (cache["k"][at], cache["v"][at])
        out, new = attention_block(
            env, bp["attn"], h, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, positions=positions, kv_cache=kv,
            kv_len=kv_len, use_rope=cfg.use_rope)
    return x + out, new


#: the type of hybrid_moe's ``route`` cache entry (expert ids)
ROUTE_DTYPE = torch.int16

#: the span of each hybrid_moe layer kind
_KIND_SPAN = {"M": "block.ssm", "E": "block.moe", "*": "block.attn"}


def _pattern_stack(env: Env, cfg: ModelConfig, params: Params,
                   x: torch.Tensor, positions: torch.Tensor, cache: Cache, *,
                   decode: bool, kv_len: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """The hybrid_moe layers in prefill (``decode`` False: each layer's
    fresh state, conv and K/V written into ``cache``) or in decode
    (``cache`` read and updated in place), each in its span; each MoE
    layer's choice of experts goes into ``route`` at the tokens'
    positions."""
    B, S = x.shape[:2]
    for bp, (kind, at) in zip(params["blocks"], _kind_index(cfg)):
        attrs = ({"rows": x.shape[0] * S * cfg.experts_per_token}
                 if kind == "E" else {})
        with _obs_span(_KIND_SPAN[kind], **attrs):
            x, new = _pattern_layer(env, cfg, bp, kind, x, positions,
                                    cache=cache if decode else None, at=at,
                                    kv_len=kv_len)
            if kind == "M":
                cache["state"][at], cache["conv"][at] = new
            elif kind == "E" and decode:
                cache["route"][at, torch.arange(B, device=x.device),
                               positions[:, 0]] = new[:, 0].to(ROUTE_DTYPE)
            elif kind == "E":
                cache["route"][at, :, :S] = new.to(ROUTE_DTYPE)
            elif not decode:
                # the cache past the prompt stays zero
                cache["k"][at, :, :S], cache["v"][at, :, :S] = new
    return x


def _logits(env: Env, cfg: ModelConfig, params: Params,
            x: torch.Tensor, gather_vocab: bool = True) -> torch.Tensor:
    x = rms_norm(x, replicated_weight(env, params["final_norm"]),
                 cfg.norm_eps)
    name = "embed" if cfg.tie_embeddings else "head"
    table = fsdp_gather(env, cfg, params[name], name)
    return lm_head(env, table, x, cfg.vocab_size, gather_vocab=gather_vocab)


def _serving(env: Env) -> Env:
    """Serving keeps the residual stream whole."""
    return (dataclasses.replace(env, seq_shard_activations=False)
            if env.seq_shard_activations else env)


def training_env(env: Env, seq_len: int) -> Env:
    """``env`` for a training forward over ``seq_len`` tokens: sequence
    parallelism only where a tp axis divides the sequence."""
    if env.seq_shard_activations and not (
            env.mesh is not None and env.tp_axis is not None
            and seq_len % env.tp == 0):
        return dataclasses.replace(env, seq_shard_activations=False)
    return env


# ---------------------------------------------------------------------------
# Forward (train) — full sequence, no cache
# ---------------------------------------------------------------------------

def _embed_prompt(env: Env, cfg: ModelConfig, params: Params,
                  batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token embeddings; vlm's ``patch_embeds`` (B, npatch, D) replace the
    first npatch of them."""
    x = embed(env, fsdp_gather(env, cfg, params["embed"], "embed"),
              batch["tokens"], cfg.vocab_size)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(x.dtype)
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    return x


def forward(env: Env, cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``batch`` is the global batch (under a mesh the rank runs its part
    over the batch axes).  Returns (logits (B, S, V), aux): ``aux`` is the
    mean of the MoE layers' load-balance losses, a zero fp32 scalar for
    the other families; under a mesh the logits are the rank's (its batch,
    and its vocabulary where ``layers.vocab_parallel``).  Differentiable;
    each layer body is checkpointed when ``env.remat``."""
    _check_family(cfg, env)
    batch = local_batch(env, batch)
    tokens = batch["tokens"]
    B, S = tokens.shape
    env = training_env(env, S)
    x = _embed_prompt(env, cfg, params, batch)
    if env.seq_shard_activations:      # the rank's block of the sequence
        x = split_to(x, env.tp_group, 1)
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    if cfg.family in _SSM_FAMILIES:
        x = _ssm_stack_forward(env, cfg, params, x, positions)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    elif cfg.family == "hybrid_moe":
        for bp, kind in zip(params["blocks"], cfg.layer_pattern):
            x = layer_call(env, lambda x, bp, kind=kind: _pattern_layer(
                env, cfg, bp, kind, x, positions)[0], x, bp)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        def body(x, bp, i):
            bp = fsdp_gather(env, cfg, bp, f"blocks/{i}")
            x, aux, _ = _attn_ffn_block(env, cfg, bp, x, positions)
            return x, aux
        auxs = []
        for i, bp in enumerate(params["blocks"]):
            x, aux = layer_call(env, body, x, bp, i)
            auxs.append(aux)
        aux = (torch.stack(auxs).mean() if cfg.family == "moe" else
               torch.zeros((), dtype=torch.float32, device=x.device))
    return _logits(env, cfg, params, x, gather_vocab=False), aux


def _ssm_stack_forward(env: Env, cfg: ModelConfig, params: Params,
                       x: torch.Tensor, positions: torch.Tensor
                       ) -> torch.Tensor:
    """Mamba2 layers, each followed by the hybrid's shared block where it
    applies; a layer and its shared block are one checkpointed body."""
    def body(x, bp, idx):
        bp = fsdp_gather(env, cfg, bp, f"blocks/{idx}")
        h = rms_norm(x, replicated_weight(env, bp["ln1"]), cfg.norm_eps)
        s, _ = ssm_block(env, bp["ssm"], h, cfg)
        x = x + s
        if _shared_applies(cfg, idx):
            shared = fsdp_gather(env, cfg, params["shared"], "shared")
            x, _, _ = _attn_ffn_block(env, cfg, shared, x, positions)
        return x
    for idx, bp in enumerate(params["blocks"]):
        x = layer_call(env, body, x, bp, idx)
    return x


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def _n_shared(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.attn_period if cfg.attn_period else 0


def local_zeros(cfg: ModelConfig, env: Env, name: str, shape, dtype
                ) -> torch.Tensor:
    """Zeros of this rank's part of the cache entry ``name`` of full
    ``shape`` (``sharding.local_cache_index``)."""
    index = local_cache_index(cfg, env, name, shape)
    local = tuple(n if ix is None else len(ix) for n, ix in zip(shape, index))
    return torch.zeros(local, dtype=dtype, device=env.device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, env: Env,
               dtype: torch.dtype = torch.bfloat16) -> Cache:
    """Dense, vlm, moe: ``k``/``v`` (L, B, max_len, K, hd).  ssm/hybrid: ``state``
    (L, B, H, hd, N), fp32 whatever ``dtype`` is, and ``conv``
    (L, B, W-1, d_conv); the hybrid adds ``shared_k``/``shared_v``
    (L // attn_period, B, max_len, K, hd).  hybrid_moe: ``state`` and
    ``conv`` for its M layers only, ``k``/``v`` for its * layers only, and
    ``route`` (E layers, B, max_len, k) int16 for its E layers, the experts
    each position chose (the MoE's record of the sequence, as K/V are the
    attention's: what a replay of the same routing reads); each layer's row
    its index among the layers of its kind.  ``batch`` is the
    global batch; under a mesh each entry is this rank's part."""
    _check_family(cfg, env)
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    kinds = cfg.layer_kinds
    shapes = {}
    if "*" in kinds:
        shapes["k"] = shapes["v"] = ((kinds.count("*"), batch, max_len, K,
                                      hd), dtype)
    if "M" in kinds:
        dims = cfg_dims(cfg)
        L = kinds.count("M")
        shapes["state"] = ((L, batch, dims["nheads"], dims["head_dim"],
                            dims["n_state"]), torch.float32)
        shapes["conv"] = ((L, batch, cfg.ssm_conv_width - 1,
                           dims["d_conv"]), dtype)
        if cfg.family == "hybrid":
            shapes["shared_k"] = shapes["shared_v"] = (
                (_n_shared(cfg), batch, max_len, K, hd), dtype)
    if "E" in kinds:
        shapes["route"] = ((kinds.count("E"), batch, max_len,
                            cfg.experts_per_token), ROUTE_DTYPE)
    return {name: local_zeros(cfg, env, name, shape, dt)
            for name, (shape, dt) in shapes.items()}


# ---------------------------------------------------------------------------
# Prefill — full prompt, returns last-position logits + populated cache
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(env: Env, cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor],
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """batch: tokens (B, S) int; vlm also ``patch_embeds`` (B, npatch, D),
    which replace the first npatch token embeddings."""
    _check_family(cfg, env)
    env = _serving(env)
    B_all, S = batch["tokens"].shape
    max_len = max_len or S
    batch = local_batch(env, batch)
    B = batch["tokens"].shape[0]
    x = _embed_prompt(env, cfg, params, batch)
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    with _obs_span("model.cache_init"):
        cache = init_cache(cfg, B_all, max_len, env, dtype=x.dtype)
    if cfg.family in _SSM_FAMILIES:
        x = _ssm_stack_prefill(env, cfg, params, x, positions, cache)
    elif cfg.family == "hybrid_moe":
        x = _pattern_stack(env, cfg, params, x, positions, cache,
                           decode=False)
    else:
        for i, bp in enumerate(params["blocks"]):
            with _obs_span("block.attn_ffn"):
                x, _, (k, v) = _attn_ffn_block(env, cfg, bp, x, positions)
                # the cache past the prompt stays zero, as the reference's
                # padding
                cache["k"][i, :, :S] = k
                cache["v"][i, :, :S] = v
    with _obs_span("model.logits"):
        return _logits(env, cfg, params, x[:, -1:]), cache


def _shared_applies(cfg: ModelConfig, idx: int) -> bool:
    """The hybrid's shared block runs after layer ``idx`` when
    (idx + 1) % attn_period == 0, as its (idx + 1) // attn_period - 1-th
    application."""
    return cfg.family == "hybrid" and (idx + 1) % cfg.attn_period == 0


def _ssm_stack_prefill(env: Env, cfg: ModelConfig, params: Params,
                       x: torch.Tensor, positions: torch.Tensor,
                       cache: Cache) -> torch.Tensor:
    """Mamba2 layers (and the hybrid's shared block), filling ``cache``."""
    S = x.shape[1]
    for idx, bp in enumerate(params["blocks"]):
        with _obs_span("block.ssm"):
            h = rms_norm(x, bp["ln1"], cfg.norm_eps)
            s, (st, conv) = ssm_block(env, bp["ssm"], h, cfg)
            x = x + s
            cache["state"][idx] = st
            cache["conv"][idx] = conv
        if _shared_applies(cfg, idx):
            app = (idx + 1) // cfg.attn_period - 1
            with _obs_span("block.shared"):
                x, _, (k, v) = _attn_ffn_block(env, cfg, params["shared"], x,
                                               positions)
                cache["shared_k"][app, :, :S] = k
                cache["shared_v"][app, :, :S] = v
    return x


# ---------------------------------------------------------------------------
# Decode — one token per sequence against the cache
# ---------------------------------------------------------------------------

@torch.no_grad()
def decode_step(env: Env, cfg: ModelConfig, params: Params, cache: Cache,
                batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Cache]:
    """batch: tokens (B,1) int, pos (B,) int (next position to write).

    Returns (logits (B,1,V), cache); the cache is updated in place.  Under
    a mesh ``batch`` is global and ``cache`` and the logits this rank's.
    """
    _check_family(cfg, env)
    env = _serving(env)
    batch = local_batch(env, batch)
    tokens, pos = batch["tokens"], batch["pos"]
    x = embed(env, params["embed"], tokens, cfg.vocab_size)
    positions = pos[:, None].long()
    kv_len = pos.long() + 1
    if cfg.family in _SSM_FAMILIES:
        x = _ssm_stack_decode(env, cfg, params, cache, x, positions, kv_len)
    elif cfg.family == "hybrid_moe":
        x = _pattern_stack(env, cfg, params, x, positions, cache,
                           decode=True, kv_len=kv_len)
    else:
        for i, bp in enumerate(params["blocks"]):
            with _obs_span("block.attn_ffn"):
                x, _, _ = _attn_ffn_block(
                    env, cfg, bp, x, positions,
                    kv_cache=(cache["k"][i], cache["v"][i]), kv_len=kv_len)
    with _obs_span("model.logits"):
        return _logits(env, cfg, params, x), cache


def _ssm_stack_decode(env: Env, cfg: ModelConfig, params: Params,
                      cache: Cache, x: torch.Tensor, positions: torch.Tensor,
                      kv_len: torch.Tensor) -> torch.Tensor:
    """One token through the Mamba2 layers (and the hybrid's shared
    block); the state, conv and shared KV caches are updated in place."""
    for idx, bp in enumerate(params["blocks"]):
        with _obs_span("block.ssm"):
            h = rms_norm(x, bp["ln1"], cfg.norm_eps)
            s, (st, conv) = ssm_block(env, bp["ssm"], h, cfg,
                                      cache=(cache["state"][idx],
                                             cache["conv"][idx]))
            x = x + s
            cache["state"][idx] = st
            cache["conv"][idx] = conv
        if _shared_applies(cfg, idx):
            app = (idx + 1) // cfg.attn_period - 1
            with _obs_span("block.shared"):
                x, _, _ = _attn_ffn_block(
                    env, cfg, params["shared"], x, positions,
                    kv_cache=(cache["shared_k"][app], cache["shared_v"][app]),
                    kv_len=kv_len)
    return x
