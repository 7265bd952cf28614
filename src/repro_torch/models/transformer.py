"""Decoder LM: the dense, moe, vlm, ssm, hybrid and hybrid_moe families.

One walker (``_layers``) runs every family's layers in every mode, a kind
a letter of ``cfg.layer_kinds``; a table gives each kind its init, its
apply, the cache entries it owns (a row a layer of the kind) and its span:

* ``*`` (``k``/``v``): dense, vlm and moe's pre-norm GQA attention + FFN
  block (SwiGLU; moe: the capacity MoE of ``models/moe.py``); hybrid_moe's
  pre-norm attention mixer alone, without RoPE (Nemotron-H)
* ``M`` (``state``/``conv``): a pre-norm Mamba2 (SSD) block, every layer of
  ssm and hybrid; hybrid_moe's with grouped B/C and the gate-first norm
* ``E`` (``route``): hybrid_moe's pre-norm dropless MoE; one device only

The hybrid (zamba2) applies ONE weight-shared attention+SwiGLU block
(``shared_k``/``shared_v``) after every ``attn_period``-th layer, a hook of
the walker.  vlm's prefill takes ``patch_embeds`` in place of its first
embeddings.

Entry points:

* ``init(cfg, gen, *, device, dtype)``            -> params
* ``forward(env, cfg, params, batch)``            -> (logits, aux)  [train]
* ``prefill(env, cfg, params, batch, max_len)``   -> (logits, cache)
* ``decode_step(env, cfg, params, cache, batch)`` -> (logits, cache)
* ``init_cache(cfg, batch, max_len, env, dtype)`` -> cache

Params: ``embed`` (V, D), ``blocks`` — a list with one dict per layer
(the attention + FFN block: ``ln1``, ``ln2``, ``attn.{wq,wk,wv,wo}``,
``mlp.{wg,wu,wd}``, moe: ``moe.{router,wg,wu,wd[,shared]}`` in place of
``mlp``; a mixer layer: ``ln1`` and one of ``ssm.{in_proj,conv_w,conv_b,
A_log,D,dt_bias,norm,out_proj}``, ``moe.{router,bias,wu,wd,shared.{wu,
wd}}`` or ``attn``), the hybrid's ``shared`` attention+MLP block,
``final_norm`` and, untied, ``head`` (V, D); projections in (out, in)
layout.  The layer stack is a Python loop; the training ``forward``
checkpoints each layer body when ``env.remat``.  The audio family is
``models/encdec.py``'s.

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

import contextlib
import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..distributed.collectives import split_to
from ..distributed.sharding import local_batch
from ..obs.trace import span as _obs_span
from .common import (Env, dense_init, embed_init, fsdp_gather, layer_call,
                     leaf, local_zeros, resolve_device, shard_kw, under,
                     zeros)
from .layers import (attention_block, embed, init_attention, init_swiglu,
                     lm_head, replicated_weight, rms_norm, swiglu)
from .moe import init_moe, init_moe_dropless, moe_dropless, moe_ffn
from .ssm import cfg_dims, init_ssm, ssm_block

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]

_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "hybrid_moe")

#: the type of hybrid_moe's ``route`` cache entry (expert ids)
ROUTE_DTYPE = torch.int16


def _check_family(cfg: ModelConfig, env: Optional[Env] = None) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"family {cfg.family!r} ({cfg.name}) is not "
                         "handled by transformer.py (audio: models/encdec.py)")
    if cfg.family == "hybrid_moe" and env is not None and \
            env.mesh is not None:
        raise ValueError(f"{cfg.name}: the hybrid_moe family runs on one "
                         "device; sharding it over a mesh is not implemented")


def _shared_period(cfg: ModelConfig) -> int:
    """The hybrid's shared block runs after every this-many-th layer, its
    (idx + 1) // period - 1-th application after layer ``idx``; 0: no
    shared block."""
    return cfg.attn_period if cfg.family == "hybrid" else 0


def _rows(cache: Optional[Cache], names: Tuple[str, ...], at: int):
    """Row ``at`` of each cache entry in ``names``; None without a cache."""
    return None if cache is None else tuple(cache[n][at] for n in names)


# ---------------------------------------------------------------------------
# The layer kinds
# ---------------------------------------------------------------------------

class _Kind(NamedTuple):
    """A kind of layer.  ``init(cfg, gen, kw)`` -> its params;
    ``apply(kind, env, cfg, params, x, positions, cache, at, kv_len)`` ->
    (x, aux, its fresh rows of the entries it owns): ``aux`` is a MoE
    block's load-balance loss, else None; ``cache`` is given in decode
    only, where apply reads its rows ``at`` (attention also writes the
    token's K/V in place)."""
    span: str
    cache: Tuple[str, ...]          # the entries it owns, a row a layer
    init: Callable
    apply: Callable
    attrs: Callable = lambda cfg, x: {}     # its span's attributes


def _init_attn(gen: torch.Generator, cfg: ModelConfig, kw: Dict[str, Any]):
    return init_attention(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim, cfg.qkv_bias, kw)


def _init_attn_ffn(cfg: ModelConfig, gen: torch.Generator,
                   kw: Dict[str, Any]) -> Params:
    """A pre-norm attention + FFN block: every dense, vlm and moe layer, and
    the hybrid's shared block."""
    D = cfg.d_model
    p: Params = {"ln1": zeros((D,), **leaf(kw, "ln1")),
                 "attn": _init_attn(gen, cfg, under(kw, "attn")),
                 "ln2": zeros((D,), **leaf(kw, "ln2"))}
    if cfg.family == "moe":
        p["moe"] = init_moe(gen, D, cfg.d_ff, cfg.num_experts,
                            cfg.shared_experts, under(kw, "moe"))
    else:
        p["mlp"] = init_swiglu(gen, D, cfg.d_ff, under(kw, "mlp"))
    return p


def _attn_ffn_block(kind: _Kind, env: Env, cfg: ModelConfig, bp: Params,
                    x: torch.Tensor, positions: torch.Tensor,
                    cache: Optional[Cache], at: int,
                    kv_len: Optional[torch.Tensor]):
    """Pre-norm attention + FFN: a dense, vlm or moe layer, or zamba2's
    weight-shared block (the reference's ``_shared_block``)."""
    kv_cache = _rows(cache, kind.cache, at)
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


def _mixer_init(name: str, init: Callable) -> Callable:
    """A mixer layer's init: its norm ``ln1``, then ``init(gen, cfg, kw)``
    under ``name``."""
    return lambda cfg, gen, kw: {
        "ln1": zeros((cfg.d_model,), **leaf(kw, "ln1")),
        name: init(gen, cfg, under(kw, name))}


def _norm(env: Env, cfg: ModelConfig, bp: Params, x: torch.Tensor):
    return rms_norm(x, replicated_weight(env, bp["ln1"]), cfg.norm_eps)


def _ssm_layer(kind, env, cfg, bp, x, positions, cache, at, kv_len):
    """``x + ssm(norm(x))``: fresh (state, conv) from the prompt, or the
    token's recurrent update of its rows."""
    h = _norm(env, cfg, bp, x)
    s, new = ssm_block(env, bp["ssm"], h, cfg,
                       cache=_rows(cache, kind.cache, at))
    return x + s, None, new


def _moe_layer(kind, env, cfg, bp, x, positions, cache, at, kv_len):
    """``x + moe(norm(x))``; its row: the experts each token chose."""
    y, ids = moe_dropless(env, bp["moe"], _norm(env, cfg, bp, x),
                          num_experts=cfg.num_experts,
                          experts_per_token=cfg.experts_per_token,
                          routed_scale=cfg.routed_scale)
    return x + y, None, (ids,)


def _attn_layer(kind, env, cfg, bp, x, positions, cache, at, kv_len):
    """``x + attention(norm(x))``, with or without RoPE."""
    h = _norm(env, cfg, bp, x)
    a, new = attention_block(
        env, bp["attn"], h, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, positions=positions,
        kv_cache=_rows(cache, kind.cache, at), kv_len=kv_len,
        use_rope=cfg.use_rope)
    return x + a, None, new


_ATTN_FFN = _Kind("block.attn_ffn", ("k", "v"), _init_attn_ffn,
                  _attn_ffn_block)
_SHARED = _Kind("block.shared", ("shared_k", "shared_v"), _init_attn_ffn,
                _attn_ffn_block)
#: the mixer layers ``x + mixer(norm(x))``, by letter
_MIXERS = {
    "M": _Kind("block.ssm", ("state", "conv"), _mixer_init("ssm", init_ssm),
               _ssm_layer),
    "E": _Kind("block.moe", ("route",), _mixer_init(
        "moe", lambda gen, cfg, kw: init_moe_dropless(
            gen, cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.shared_width,
            kw)), _moe_layer, lambda cfg, x: {
                "rows": x.shape[0] * x.shape[1] * cfg.experts_per_token}),
    "*": _Kind("block.attn", ("k", "v"), _mixer_init("attn", _init_attn),
               _attn_layer),
}


def _kinds(cfg: ModelConfig) -> Dict[str, _Kind]:
    """The kind of each letter of ``cfg.layer_kinds``: every hybrid_moe
    layer is a mixer; the attention families' ``*`` is the attention +
    FFN block."""
    if cfg.family == "hybrid_moe":
        return _MIXERS
    return {**_MIXERS, "*": _ATTN_FFN}


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
    kinds = _kinds(cfg)
    p: Params = {"embed": embed_init(gen, (V, D), **leaf(kw, "embed")),
                 "blocks": [kinds[kind].init(cfg, gen,
                                             under(kw, f"blocks/{i}"))
                            for i, kind in enumerate(cfg.layer_kinds)]}
    if _shared_period(cfg):
        p["shared"] = _SHARED.init(cfg, gen, under(kw, "shared"))
    p["final_norm"] = zeros((D,), **leaf(kw, "final_norm"))
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (V, D), **leaf(kw, "head"))
    return p


# ---------------------------------------------------------------------------
# The walker
# ---------------------------------------------------------------------------

def _store(cache: Optional[Cache], names: Tuple[str, ...], at: int,
           new, positions: torch.Tensor, decode: bool) -> None:
    """The one place a layer's fresh rows enter the cache (none in the
    training forward): Mamba2 ``state``/``conv`` whole; in prefill the
    prompt's K/V and routes at ``[:, :S]``, the cache past the prompt left
    zero as the reference's padding; in decode a token's routes at its
    position (its K/V the attention wrote in place)."""
    if cache is None:
        return
    for name, t in zip(names, new):
        if name in ("state", "conv"):
            cache[name][at] = t
        elif not decode:
            cache[name][at, :, :t.shape[1]] = t.to(cache[name].dtype)
        elif name == "route":
            cache[name][at, torch.arange(t.shape[0], device=t.device),
                        positions[:, 0]] = t[:, 0].to(cache[name].dtype)


def _layers(env: Env, cfg: ModelConfig, params: Params, x: torch.Tensor,
            positions: torch.Tensor, *, cache: Optional[Cache] = None,
            decode: bool = False, kv_len: Optional[torch.Tensor] = None):
    """Every layer of ``cfg.layer_kinds`` in order, each followed by the
    hybrid's shared block where it applies; a layer and its shared block
    are one body of ``layer_call`` that gathers their weights
    (``fsdp_gather``).  Without ``cache`` (the training forward) no span
    opens.  With it each layer and shared block runs in its span: prefill
    (``decode`` False) writes the fresh rows into ``cache``, decode reads
    and updates them in place.  Returns (x, the MoE blocks' load-balance
    losses)."""
    kinds, period = _kinds(cfg), _shared_period(cfg)
    span = ((lambda name, **attrs: contextlib.nullcontext())
            if cache is None else _obs_span)
    reads = cache if decode else None

    def run(kind, bp, x, at):
        with span(kind.span, **kind.attrs(cfg, x)):
            x, aux, new = kind.apply(kind, env, cfg, bp, x, positions, reads,
                                     at, kv_len)
            _store(cache, kind.cache, at, new, positions, decode)
        return x, aux

    def body(x, bp, idx, kind, at):
        x, aux = run(kind, fsdp_gather(env, cfg, bp, f"blocks/{idx}"), x, at)
        if period and (idx + 1) % period == 0:
            shared = fsdp_gather(env, cfg, params["shared"], "shared")
            x, _ = run(_SHARED, shared, x, (idx + 1) // period - 1)
        return x, aux

    auxs, letters = [], cfg.layer_kinds
    for idx, (bp, letter) in enumerate(zip(params["blocks"], letters)):
        at = letters[:idx].count(letter)     # its row: its index in its kind
        x, aux = layer_call(env, body, x, bp, idx, kinds[letter], at)
        if aux is not None:
            auxs.append(aux)
    return x, auxs


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
    x, auxs = _layers(env, cfg, params, x, positions)
    aux = (torch.stack(auxs).mean() if auxs else
           torch.zeros((), dtype=torch.float32, device=x.device))
    return _logits(env, cfg, params, x, gather_vocab=False), aux


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, env: Env,
               dtype: torch.dtype = torch.bfloat16) -> Cache:
    """Dense, vlm, moe: ``k``/``v`` (L, B, max_len, K, hd).  ssm/hybrid:
    ``state`` (L, B, H, hd, N), fp32 whatever ``dtype`` is, and ``conv``
    (L, B, W-1, d_conv); the hybrid adds ``shared_k``/``shared_v``
    (L // attn_period, B, max_len, K, hd).  hybrid_moe: ``state`` and
    ``conv`` for its M layers only, ``k``/``v`` for its * layers only, and
    ``route`` (E layers, B, max_len, k) int16 for its E layers, the experts
    each position chose (the MoE's record of the sequence, as K/V are the
    attention's: what a replay of the same routing reads); each layer's row
    its index among the layers of its kind.  ``batch`` is the
    global batch; under a mesh each entry is this rank's part."""
    _check_family(cfg, env)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    kinds, period = cfg.layer_kinds, _shared_period(cfg)
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
    if period:
        shapes["shared_k"] = shapes["shared_v"] = (
            (cfg.num_layers // period, batch, max_len, K, hd), dtype)
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
    x, _ = _layers(env, cfg, params, x, positions, cache=cache)
    with _obs_span("model.logits"):
        return _logits(env, cfg, params, x[:, -1:]), cache


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
    x, _ = _layers(env, cfg, params, x, positions, cache=cache, decode=True,
                   kv_len=pos.long() + 1)
    with _obs_span("model.logits"):
        return _logits(env, cfg, params, x), cache
