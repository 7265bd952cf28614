"""Decoder LM, dense family: pre-norm GQA attention + SwiGLU per layer.

Entry points:

* ``init(cfg, gen, *, device, dtype)``            -> params
* ``prefill(env, cfg, params, batch, max_len)``   -> (logits, cache)
* ``decode_step(env, cfg, params, cache, batch)`` -> (logits, cache)
* ``init_cache(cfg, batch, max_len, env, dtype)`` -> cache

Params: ``embed`` (V, D), ``blocks`` — a list with one dict per layer
(``ln1``, ``ln2``, ``attn.{wq,wk,wv,wo}``, ``mlp.{wg,wu,wd}``, projections
in (out, in) layout) — ``final_norm`` and, untied, ``head`` (V, D).  The
layer stack is a Python loop.  The other families of the reference
(moe, ssm, hybrid, vlm, audio) wait for their slices.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from .common import Env, dense_init, embed_init, resolve_device
from .layers import attention_block, embed, lm_head, rms_norm, swiglu

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]

#: ROADMAP.md's item for each family this module does not carry yet
_FAMILY_ITEM = {
    "ssm": "ROADMAP.md Queue 1, 'The SSM path' (mamba2-370m)",
    "hybrid": "ROADMAP.md Queue 1, 'The SSM path' (zamba2 hybrid)",
    "moe": "ROADMAP.md Queue 1, 'Other model families' (moe)",
    "vlm": "ROADMAP.md Queue 1, 'Other model families' (vlm)",
    "audio": "ROADMAP.md Queue 1, 'Other model families' (audio)",
}


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        item = _FAMILY_ITEM.get(cfg.family, "ROADMAP.md Queue 1")
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: {item}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, gen: torch.Generator, *,
         device: Optional[torch.device] = None,
         dtype: torch.dtype = torch.float32) -> Params:
    """Random weights from ``gen`` with the reference's distributions:
    truncated normal / sqrt(fan_in) for projections, normal x 0.02 for the
    embedding, zeros for the (1 + scale) norm gains."""
    _require_dense(cfg)
    dev = resolve_device(device)
    D, F_, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(device=dev, dtype=dtype)
    p: Params = {"embed": embed_init(gen, (V, D), **kw), "blocks": []}
    for _ in range(cfg.num_layers):
        attn = {"wq": dense_init(gen, (H * hd, D), **kw),
                "wk": dense_init(gen, (K * hd, D), **kw),
                "wv": dense_init(gen, (K * hd, D), **kw),
                "wo": dense_init(gen, (D, H * hd), **kw)}
        if cfg.qkv_bias:
            attn["bq"] = torch.zeros(H * hd, **kw)
            attn["bk"] = torch.zeros(K * hd, **kw)
            attn["bv"] = torch.zeros(K * hd, **kw)
        p["blocks"].append({
            "ln1": torch.zeros(D, **kw),
            "attn": attn,
            "ln2": torch.zeros(D, **kw),
            "mlp": {"wg": dense_init(gen, (F_, D), **kw),
                    "wu": dense_init(gen, (F_, D), **kw),
                    "wd": dense_init(gen, (D, F_), **kw)},
        })
    p["final_norm"] = torch.zeros(D, **kw)
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (V, D), **kw)
    return p


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _attn_ffn_block(env: Env, cfg: ModelConfig, bp: Params, x: torch.Tensor,
                    positions: torch.Tensor, *,
                    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    kv_len: Optional[torch.Tensor] = None):
    """Pre-norm attention + SwiGLU.  Returns (x, new_kv)."""
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    a, new_kv = attention_block(
        env, bp["attn"], h, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, positions=positions,
        kv_cache=kv_cache, kv_len=kv_len)
    x = x + a
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + swiglu(env, bp["mlp"], h), new_kv


def _logits(env: Env, cfg: ModelConfig, params: Params,
            x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["head"]
    return lm_head(env, table, x)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, env: Env,
               dtype: torch.dtype = torch.bfloat16) -> Cache:
    _require_dense(cfg)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=env.device),
            "v": torch.zeros(shape, dtype=dtype, device=env.device)}


# ---------------------------------------------------------------------------
# Prefill — full prompt, returns last-position logits + populated cache
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(env: Env, cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor],
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    _require_dense(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    max_len = max_len or S
    x = embed(env, params["embed"], tokens)
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    cache = init_cache(cfg, B, max_len, env, dtype=x.dtype)
    for i, bp in enumerate(params["blocks"]):
        x, (k, v) = _attn_ffn_block(env, cfg, bp, x, positions)
        # the cache past the prompt stays zero, as the reference's padding
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    return _logits(env, cfg, params, x[:, -1:]), cache


# ---------------------------------------------------------------------------
# Decode — one token per sequence against the cache
# ---------------------------------------------------------------------------

@torch.no_grad()
def decode_step(env: Env, cfg: ModelConfig, params: Params, cache: Cache,
                batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Cache]:
    """batch: tokens (B,1) int, pos (B,) int (next position to write).

    Returns (logits (B,1,V), cache); the cache is updated in place.
    """
    _require_dense(cfg)
    tokens, pos = batch["tokens"], batch["pos"]
    x = embed(env, params["embed"], tokens)
    positions = pos[:, None].long()
    kv_len = pos.long() + 1
    for i, bp in enumerate(params["blocks"]):
        x, _ = _attn_ffn_block(env, cfg, bp, x, positions,
                               kv_cache=(cache["k"][i], cache["v"][i]),
                               kv_len=kv_len)
    return _logits(env, cfg, params, x), cache
