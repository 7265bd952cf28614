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
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from .common import Env, embed_init, layer_call, resolve_device
from .layers import (_linear, attention_block, embed, gelu_mlp,
                     init_attention, init_gelu_mlp, layer_norm, lm_head)

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]

#: rows of the decoder's learned position table
POS_ROWS = 4096


def _init_ln(d: int, kw: Dict[str, Any]) -> Params:
    return {"scale": torch.ones(d, **kw), "bias": torch.zeros(d, **kw)}


def _init_attention(cfg: ModelConfig, gen: torch.Generator,
                    kw: Dict[str, Any]) -> Params:
    return init_attention(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim, True, kw)


def _init_enc_layer(cfg: ModelConfig, gen: torch.Generator,
                    kw: Dict[str, Any]) -> Params:
    return {"ln1": _init_ln(cfg.d_model, kw),
            "attn": _init_attention(cfg, gen, kw),
            "ln2": _init_ln(cfg.d_model, kw),
            "mlp": init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, kw)}


def _init_dec_layer(cfg: ModelConfig, gen: torch.Generator,
                    kw: Dict[str, Any]) -> Params:
    return {"ln1": _init_ln(cfg.d_model, kw),
            "self_attn": _init_attention(cfg, gen, kw),
            "ln_x": _init_ln(cfg.d_model, kw),
            "cross_attn": _init_attention(cfg, gen, kw),
            "ln2": _init_ln(cfg.d_model, kw),
            "mlp": init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, kw)}


def init(cfg: ModelConfig, gen: torch.Generator, *,
         device: Optional[torch.device] = None,
         dtype: torch.dtype = torch.float32) -> Params:
    """Random weights from ``gen`` with the reference's distributions
    (LayerNorm scales 1, biases 0)."""
    kw = dict(device=resolve_device(device), dtype=dtype)
    D = cfg.d_model
    return {
        "embed": embed_init(gen, (cfg.vocab_size, D), **kw),
        "pos_embed": embed_init(gen, (POS_ROWS, D), **kw),
        "enc_blocks": [_init_enc_layer(cfg, gen, kw)
                       for _ in range(cfg.encoder_layers)],
        "enc_norm": _init_ln(D, kw),
        "dec_blocks": [_init_dec_layer(cfg, gen, kw)
                       for _ in range(cfg.num_layers)],
        "dec_norm": _init_ln(D, kw),
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

    def body(x, bp):
        h = _ln(x, bp["ln1"], cfg.norm_eps)
        a, _ = _attend(env, cfg, bp["attn"], h, positions, causal=False)
        x = x + a
        h = _ln(x, bp["ln2"], cfg.norm_eps)
        return x + gelu_mlp(env, bp["mlp"], h)
    for bp in params["enc_blocks"]:
        x = layer_call(env, body, x, bp)
    return _ln(x, params["enc_norm"], cfg.norm_eps)


@torch.no_grad()
def encode(env: Env, cfg: ModelConfig, params: Params,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: stubbed (B, S_enc, D) embeddings -> encoder states."""
    return _encode(env, cfg, params, frames)


def _cross_kv(env: Env, cfg: ModelConfig, dec_blocks: List[Params],
              enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each decoder layer's cross-attention K/V of the encoder output,
    stacked: (L, B, S_enc, K, hd) x2."""
    B, S, _ = enc_out.shape
    shape = (B, S, cfg.num_kv_heads, cfg.head_dim)
    ks, vs = [], []
    for bp in dec_blocks:
        ca = bp["cross_attn"]
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
    return x + gelu_mlp(env, bp["mlp"], h), new_kv


def _positions_embed(params: Params, pos: torch.Tensor) -> torch.Tensor:
    """Rows of the learned position table; positions past its end take
    its last row, as the reference clips them."""
    table = params["pos_embed"]
    return table[pos.clamp(max=table.shape[0] - 1)]


def _embed_tokens(env: Env, params: Params, tokens: torch.Tensor,
                  pos: torch.Tensor) -> torch.Tensor:
    x = embed(env, params["embed"], tokens)
    return x + _positions_embed(params, pos).to(x.dtype)


def _logits(env: Env, cfg: ModelConfig, params: Params,
            x: torch.Tensor) -> torch.Tensor:
    return lm_head(env, params["embed"],
                   _ln(x, params["dec_norm"], cfg.norm_eps))


def forward(env: Env, cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced training forward over ``tokens`` with encoder
    ``frames``; returns (logits (B, S, V), a zero fp32 aux loss)."""
    enc_out = _encode(env, cfg, params, batch["frames"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    x = _embed_tokens(env, params, tokens, positions)
    cross_k, cross_v = _cross_kv(env, cfg, params["dec_blocks"], enc_out)

    def body(x, bp, ck, cv):
        return _dec_block(env, cfg, bp, x, positions, cross=(ck, cv))[0]
    for i, bp in enumerate(params["dec_blocks"]):
        x = layer_call(env, body, x, bp, cross_k[i], cross_v[i])
    return (_logits(env, cfg, params, x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, env: Env,
               dtype: torch.dtype = torch.bfloat16) -> Cache:
    kw = dict(dtype=dtype, device=env.device)
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((L, batch, max_len, K, hd), **kw),
            "v": torch.zeros((L, batch, max_len, K, hd), **kw),
            "cross_k": torch.zeros((L, batch, cfg.encoder_seq, K, hd), **kw),
            "cross_v": torch.zeros((L, batch, cfg.encoder_seq, K, hd), **kw)}


@torch.no_grad()
def prefill(env: Env, cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor],
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """Encode ``frames``, then a teacher-forced decoder pass over ``tokens``
    that fills the self-attention cache; returns last-position logits."""
    enc_out = encode(env, cfg, params, batch["frames"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    max_len = max_len or S
    positions = _positions(B, S, tokens.device)
    x = _embed_tokens(env, params, tokens, positions)
    cross_k, cross_v = _cross_kv(env, cfg, params["dec_blocks"], enc_out)
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    kw = dict(dtype=x.dtype, device=x.device)
    cache: Cache = {"k": torch.zeros((L, B, max_len, K, hd), **kw),
                    "v": torch.zeros((L, B, max_len, K, hd), **kw),
                    "cross_k": cross_k, "cross_v": cross_v}
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
    place, the cross-attention K/V are read."""
    tokens, pos = batch["tokens"], batch["pos"]
    positions = pos[:, None].long()
    kv_len = pos.long() + 1
    x = _embed_tokens(env, params, tokens, positions)
    for i, bp in enumerate(params["dec_blocks"]):
        x, _ = _dec_block(env, cfg, bp, x, positions,
                          kv_cache=(cache["k"][i], cache["v"][i]),
                          kv_len=kv_len,
                          cross=(cache["cross_k"][i], cache["cross_v"][i]))
    return _logits(env, cfg, params, x), cache
