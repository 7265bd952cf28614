"""Encoder-decoder (the whisper-large-v3 backbone): the serving half of the
reference's ``repro/models/encdec.py``.

The conv/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, encoder_seq, d_model).  Pre-LN LayerNorm
blocks with GELU fc1/fc2 MLPs and biased projections, no RoPE: the encoder
attends without a mask; the decoder adds a learned position table
(``pos_embed``, 4096 rows, clipped at its end), attends causally over its
tokens (the flash kernel on a prompt) and across to the encoder's output
(plain tensor code, as the reference runs it outside Pallas).  The logits
use the tied ``embed``.

Entry points as ``transformer.py``'s: ``init``, ``forward`` (training:
teacher-forced over ``tokens`` with ``frames``, each layer checkpointed
when ``env.remat``), ``prefill`` (batch: ``tokens`` and ``frames``),
``decode_step``, ``init_cache``.  The cache
holds the decoder's self-attention ``k``/``v`` (L, B, max_len, K, hd) and
the cross-attention ``cross_k``/``cross_v`` (L, B, encoder_seq, K, hd) that
prefill computes once from the encoder.  Params: ``embed``, ``pos_embed``,
``enc_blocks`` and ``dec_blocks`` (lists, one dict per layer: ``ln1``,
``attn`` or ``self_attn``/``ln_x``/``cross_attn``, ``ln2``,
``mlp.{w1,b1,w2,b2}``; LayerNorms ``{scale, bias}``), ``enc_norm``,
``dec_norm``.

Under a mesh the entry points work on this rank's shard as
``transformer.py``'s do: attention on local heads (the cross-attention's
K/V are the rank's KV heads), the GELU MLPs column- then row-parallel, the
tied vocabulary split over tp where it divides; ``forward`` takes the
training layout and gathers each layer's weights over the batch axes in
its body (the cross-attention's K/V weights where all layers' K/V are
projected at once).  Sequence parallelism
(``Env.seq_shard_activations``) is not applied here: the encoder's states
feed every decoder layer's cross-attention whole, so the residual streams
stay whole, as with the knob off.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import dataclasses

import torch

from ..configs.base import ModelConfig
from ..distributed.collectives import copy_to
from ..distributed.sharding import local_batch
from .common import (Env, embed_init, fsdp_gather, layer_call, leaf,
                     local_zeros, ones, resolve_device, shard_kw, under, zeros)
from .layers import (_linear, attention_block, embed, gelu_mlp,
                     init_attention, init_gelu_mlp, layer_norm, lm_head)

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]

#: rows of the decoder's learned position table
POS_ROWS = 4096


def _init_ln(d: int, kw: Dict[str, Any]) -> Params:
    return {"scale": ones((d,), **leaf(kw, "scale")),
            "bias": zeros((d,), **leaf(kw, "bias"))}


def _init_attention(cfg: ModelConfig, gen: torch.Generator,
                    kw: Dict[str, Any]) -> Params:
    return init_attention(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim, True, kw)


def _init_enc_layer(cfg: ModelConfig, gen: torch.Generator,
                    kw: Dict[str, Any]) -> Params:
    return {"ln1": _init_ln(cfg.d_model, under(kw, "ln1")),
            "attn": _init_attention(cfg, gen, under(kw, "attn")),
            "ln2": _init_ln(cfg.d_model, under(kw, "ln2")),
            "mlp": init_gelu_mlp(gen, cfg.d_model, cfg.d_ff,
                                 under(kw, "mlp"))}


def _init_dec_layer(cfg: ModelConfig, gen: torch.Generator,
                    kw: Dict[str, Any]) -> Params:
    return {"ln1": _init_ln(cfg.d_model, under(kw, "ln1")),
            "self_attn": _init_attention(cfg, gen, under(kw, "self_attn")),
            "ln_x": _init_ln(cfg.d_model, under(kw, "ln_x")),
            "cross_attn": _init_attention(cfg, gen, under(kw, "cross_attn")),
            "ln2": _init_ln(cfg.d_model, under(kw, "ln2")),
            "mlp": init_gelu_mlp(gen, cfg.d_model, cfg.d_ff,
                                 under(kw, "mlp"))}


def init(cfg: ModelConfig, gen: torch.Generator, *,
         device: Optional[torch.device] = None,
         dtype: torch.dtype = torch.float32,
         env: Optional[Env] = None, fsdp: bool = False) -> Params:
    """Random weights from ``gen`` with the reference's distributions
    (LayerNorm scales 1, biases 0); under ``env``'s mesh only this rank's
    shard of each leaf (with ``fsdp``, the training layout's)."""
    kw = shard_kw(cfg, env, resolve_device(device), dtype, fsdp)
    D = cfg.d_model
    return {
        "embed": embed_init(gen, (cfg.vocab_size, D), **leaf(kw, "embed")),
        "pos_embed": embed_init(gen, (POS_ROWS, D), **leaf(kw, "pos_embed")),
        "enc_blocks": [_init_enc_layer(cfg, gen, under(kw, f"enc_blocks/{i}"))
                       for i in range(cfg.encoder_layers)],
        "enc_norm": _init_ln(D, under(kw, "enc_norm")),
        "dec_blocks": [_init_dec_layer(cfg, gen, under(kw, f"dec_blocks/{i}"))
                       for i in range(cfg.num_layers)],
        "dec_norm": _init_ln(D, under(kw, "dec_norm")),
    }


def _ln(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    return layer_norm(x, p["scale"], p["bias"], eps)


def _attend(env: Env, cfg: ModelConfig, p: Params, h: torch.Tensor,
            positions: torch.Tensor, **kw):
    return attention_block(env, p, h, num_heads=cfg.num_heads,
                           num_kv_heads=cfg.num_kv_heads,
                           head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                           positions=positions, use_rope=False, **kw)


def _positions(B: int, S: int, device: torch.device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def _encode(env: Env, cfg: ModelConfig, params: Params,
            frames: torch.Tensor) -> torch.Tensor:
    """The encoder, differentiable; each layer checkpointed when
    ``env.remat`` and grad is on.  Its attention is non-causal and stays
    plain tensor code, as the reference's."""
    x = frames.to(env.compute_dtype)
    positions = _positions(x.shape[0], x.shape[1], x.device)

    def body(x, bp, i):
        bp = fsdp_gather(env, cfg, bp, f"enc_blocks/{i}")
        h = _ln(x, bp["ln1"], cfg.norm_eps)
        a, _ = _attend(env, cfg, bp["attn"], h, positions, causal=False)
        x = x + a
        h = _ln(x, bp["ln2"], cfg.norm_eps)
        return x + gelu_mlp(env, bp["mlp"], h, cfg.d_ff)
    for i, bp in enumerate(params["enc_blocks"]):
        x = layer_call(env, body, x, bp, i)
    return _ln(x, params["enc_norm"], cfg.norm_eps)


@torch.no_grad()
def encode(env: Env, cfg: ModelConfig, params: Params,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: stubbed (B, S_enc, D) embeddings -> encoder states."""
    return _encode(env, cfg, params, frames)


def _cross_kv(env: Env, cfg: ModelConfig, dec_blocks: List[Params],
              enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each decoder layer's cross-attention K/V of the encoder output,
    stacked: (L, B, S_enc, K, hd) x2.  Under a mesh the K/V weights are
    gathered over the batch axes here; where the heads split over tp, the
    ranks' K/V each add a part to the encoder output's gradient."""
    B, S, _ = enc_out.shape
    if env.mesh is not None and env.tp_shards(cfg.num_heads):
        enc_out = copy_to(enc_out, env.tp_group)
    ks, vs = [], []
    for i, bp in enumerate(dec_blocks):
        ca = fsdp_gather(env, cfg, bp["cross_attn"],
                         f"dec_blocks/{i}/cross_attn", skip=("wq", "bq",
                                                             "wo"))
        shape = (B, S, ca["wk"].shape[0] // cfg.head_dim, cfg.head_dim)
        ks.append(_linear(enc_out, ca["wk"], ca["bk"]).reshape(shape))
        vs.append(_linear(enc_out, ca["wv"], ca["bv"]).reshape(shape))
    return torch.stack(ks), torch.stack(vs)


def _dec_block(env: Env, cfg: ModelConfig, bp: Params, x: torch.Tensor,
               positions: torch.Tensor, *, cross: Tuple[torch.Tensor,
                                                         torch.Tensor],
               kv_cache=None, kv_len=None):
    h = _ln(x, bp["ln1"], cfg.norm_eps)
    a, new_kv = _attend(env, cfg, bp["self_attn"], h, positions,
                        kv_cache=kv_cache, kv_len=kv_len)
    x = x + a
    h = _ln(x, bp["ln_x"], cfg.norm_eps)
    a, _ = _attend(env, cfg, bp["cross_attn"], h, positions, cross_kv=cross)
    x = x + a
    h = _ln(x, bp["ln2"], cfg.norm_eps)
    return x + gelu_mlp(env, bp["mlp"], h, cfg.d_ff), new_kv


def _positions_embed(params: Params, pos: torch.Tensor) -> torch.Tensor:
    """Rows of the learned position table; positions past its end take
    its last row, as the reference clips them."""
    table = params["pos_embed"]
    return table[pos.clamp(max=table.shape[0] - 1)]


def _embed_tokens(env: Env, cfg: ModelConfig, params: Params,
                  tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    table = fsdp_gather(env, cfg, params["embed"], "embed")
    x = embed(env, table, tokens, cfg.vocab_size)
    pos_table = {"pos_embed": fsdp_gather(env, cfg, params["pos_embed"],
                                          "pos_embed")}
    return x + _positions_embed(pos_table, pos).to(x.dtype)


def _logits(env: Env, cfg: ModelConfig, params: Params,
            x: torch.Tensor, gather_vocab: bool = True) -> torch.Tensor:
    return lm_head(env, fsdp_gather(env, cfg, params["embed"], "embed"),
                   _ln(x, params["dec_norm"], cfg.norm_eps), cfg.vocab_size,
                   gather_vocab=gather_vocab)


def forward(env: Env, cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced training forward over ``tokens`` with encoder
    ``frames`` (the global batch: under a mesh the rank runs its part);
    returns (logits (B, S, V), a zero fp32 aux loss), the logits the
    rank's as ``transformer.forward``'s."""
    if env.seq_shard_activations:
        env = dataclasses.replace(env, seq_shard_activations=False)
    batch = local_batch(env, batch)
    enc_out = _encode(env, cfg, params, batch["frames"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    x = _embed_tokens(env, cfg, params, tokens, positions)
    cross_k, cross_v = _cross_kv(env, cfg, params["dec_blocks"], enc_out)
    cross_weights = ("cross_attn/wk", "cross_attn/wv", "cross_attn/bk",
                     "cross_attn/bv")

    def body(x, bp, i, ck, cv):
        bp = fsdp_gather(env, cfg, bp, f"dec_blocks/{i}", skip=cross_weights)
        return _dec_block(env, cfg, bp, x, positions, cross=(ck, cv))[0]
    for i, bp in enumerate(params["dec_blocks"]):
        x = layer_call(env, body, x, bp, i, cross_k[i], cross_v[i])
    return (_logits(env, cfg, params, x, gather_vocab=False),
            torch.zeros((), dtype=torch.float32, device=x.device))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, env: Env,
               dtype: torch.dtype = torch.bfloat16) -> Cache:
    """``batch`` is the global batch; under a mesh each entry is this
    rank's part."""
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    shapes = {"k": (L, batch, max_len, K, hd), "v": (L, batch, max_len, K, hd),
              "cross_k": (L, batch, cfg.encoder_seq, K, hd),
              "cross_v": (L, batch, cfg.encoder_seq, K, hd)}
    return {name: local_zeros(cfg, env, name, shape, dtype)
            for name, shape in shapes.items()}


@torch.no_grad()
def prefill(env: Env, cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor],
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """Encode ``frames``, then a teacher-forced decoder pass over ``tokens``
    that fills the self-attention cache; returns last-position logits.
    Under a mesh ``batch`` is global; the logits and cache are this
    rank's."""
    B_all, S = batch["tokens"].shape
    max_len = max_len or S
    batch = local_batch(env, batch)
    enc_out = encode(env, cfg, params, batch["frames"])
    tokens = batch["tokens"]
    B = tokens.shape[0]
    positions = _positions(B, S, tokens.device)
    x = _embed_tokens(env, cfg, params, tokens, positions)
    cross_k, cross_v = _cross_kv(env, cfg, params["dec_blocks"], enc_out)
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    cache: Cache = {
        name: local_zeros(cfg, env, name, (L, B_all, max_len, K, hd), x.dtype)
        for name in ("k", "v")}
    cache.update(cross_k=cross_k, cross_v=cross_v)
    for i, bp in enumerate(params["dec_blocks"]):
        x, (k, v) = _dec_block(env, cfg, bp, x, positions,
                               cross=(cross_k[i], cross_v[i]))
        # the cache past the prompt stays zero, as the reference's padding
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    return _logits(env, cfg, params, x[:, -1:]), cache


@torch.no_grad()
def decode_step(env: Env, cfg: ModelConfig, params: Params, cache: Cache,
                batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Cache]:
    """batch: tokens (B,1) int, pos (B,) int (next position to write).

    Returns (logits (B,1,V), cache); the self-attention cache is updated in
    place, the cross-attention K/V are read.  Under a mesh ``batch`` is
    global and ``cache`` and the logits this rank's."""
    batch = local_batch(env, batch)
    tokens, pos = batch["tokens"], batch["pos"]
    positions = pos[:, None].long()
    kv_len = pos.long() + 1
    x = _embed_tokens(env, cfg, params, tokens, positions)
    for i, bp in enumerate(params["dec_blocks"]):
        x, _ = _dec_block(env, cfg, bp, x, positions,
                          kv_cache=(cache["k"][i], cache["v"][i]),
                          kv_len=kv_len,
                          cross=(cache["cross_k"][i], cache["cross_v"][i]))
    return _logits(env, cfg, params, x), cache
