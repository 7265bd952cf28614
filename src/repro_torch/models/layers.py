"""Model building blocks: RMS and layer norms, RoPE, GQA attention, the
SwiGLU and GELU MLPs, embeddings.

Plain functions over parameter dicts with the reference's key names.
Projection weights are in ``nn.Linear``'s (out, in) layout and applied with
``F.linear``; causal attention over a prompt goes to the flash kernel
(:func:`repro_torch.kernels.flash_attention.ops.flash_attention`); decode
against a cache, non-causal (encoder) attention and cross-attention stay
plain tensor code, as the reference runs them outside Pallas.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_attention.ops import flash_attention
from .common import Env, dense_init

Params = Dict[str, Any]
KV = Tuple[torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    # zero-init scale with a (1 + scale) gain
    return (y * (1.0 + scale.float())).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int.  Split-half rotation."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # (hd/2,)
    angles = positions[..., None].float() * freqs              # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional bias) — prefill / decode
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, d_model: int, num_heads: int,
                   num_kv_heads: int, head_dim: int, qkv_bias: bool,
                   kw: Dict[str, Any]) -> Params:
    """``kw``: the ``device``/``dtype`` of every tensor."""
    H, K, hd = num_heads, num_kv_heads, head_dim
    p: Params = {"wq": dense_init(gen, (H * hd, d_model), **kw),
                 "wk": dense_init(gen, (K * hd, d_model), **kw),
                 "wv": dense_init(gen, (K * hd, d_model), **kw),
                 "wo": dense_init(gen, (d_model, H * hd), **kw)}
    if qkv_bias:
        p["bq"] = torch.zeros(H * hd, **kw)
        p["bk"] = torch.zeros(K * hd, **kw)
        p["bv"] = torch.zeros(K * hd, **kw)
    return p


def _mha(env: Env, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool, q_offset: Optional[torch.Tensor] = None,
         kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,Sq,H,hd), k/v: (B,Sk,K,hd) with H = G*K.

    ``q_offset``: (B,) absolute position of q[:,0].  ``kv_len``: (B,) valid
    KV length (continuous batching).  Causal attention over more than one
    query goes to the flash kernel; the rest (decode) is plain tensor code.
    """
    if causal and q.shape[1] > 1:
        return flash_attention(q, k, v, q_offset=q_offset)
    return _mha_dense(env, q, k, v, causal=causal, q_offset=q_offset,
                      kv_len=kv_len)


def _mha_dense(env: Env, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               *, causal: bool, q_offset: Optional[torch.Tensor] = None,
               kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = hd ** -0.5
    qf = (q * scale).float().reshape(B, Sq, K, G, hd)
    kf = k.float()
    vf = v.float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, kf)        # (B,K,G,Sq,Sk)
    Sk = k.shape[1]
    q_pos = torch.arange(Sq, device=q.device)[None, :]          # (1,Sq)
    if q_offset is not None:
        q_pos = q_pos + q_offset[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]          # (1,Sk)
    mask = torch.ones((q_pos.shape[0], Sq, Sk), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask = mask & (q_pos[:, :, None] >= k_pos[:, None, :])
    if kv_len is not None:
        mask = mask & (k_pos[:, None, :] < kv_len[:, None, None])
    logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, vf)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _linear(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None) -> torch.Tensor:
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


def attention_block(env: Env, p: Params, x: torch.Tensor, *, num_heads: int,
                    num_kv_heads: int, head_dim: int, rope_theta: float,
                    positions: torch.Tensor, causal: bool = True,
                    kv_cache: Optional[KV] = None,
                    kv_len: Optional[torch.Tensor] = None,
                    cross_kv: Optional[KV] = None,
                    use_rope: bool = True,
                    ) -> Tuple[torch.Tensor, Optional[KV]]:
    """One attention sublayer (no norm/residual).

    Modes:
    * prefill: kv_cache None -> self-attention over the prompt (causal
      unless ``causal=False``, as the whisper encoder's); returns the fresh
      (k, v) so prefill can populate a cache.
    * decode: kv_cache=(k_cache, v_cache) of shape (B, S_max, K, hd); the
      single new (k, v) is written at ``positions`` IN PLACE and attention
      runs over the cache with ``kv_len`` masking.
    * cross-attention: ``cross_kv`` precomputed from the encoder (masked by
      ``kv_len`` if given); returns no cache.
    ``use_rope=False`` leaves q and k unrotated (whisper).
    """
    B, Sq, _ = x.shape
    H, K, hd = num_heads, num_kv_heads, head_dim
    q = _linear(x, p["wq"], p.get("bq")).reshape(B, Sq, H, hd)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)

    if cross_kv is not None:
        k, v = cross_kv
        out = _mha(env, q, k, v, causal=False, kv_len=kv_len)
        return _linear(out.reshape(B, Sq, H * hd), p["wo"]), None

    k = _linear(x, p["wk"], p.get("bk")).reshape(B, Sq, K, hd)
    v = _linear(x, p["wv"], p.get("bv")).reshape(B, Sq, K, hd)
    if use_rope:
        k = apply_rope(k, positions, rope_theta)

    if kv_cache is None:
        out = _mha(env, q, k, v, causal=causal,
                   q_offset=positions[:, 0] if causal else None)
        new_cache = (k, v)
    else:
        k_cache, v_cache = kv_cache
        b_idx = torch.arange(B, device=x.device)
        # write the new token's K/V at its position (per-sequence), in place
        pos = positions[:, 0]
        k_cache[b_idx, pos] = k[:, 0].to(k_cache.dtype)
        v_cache[b_idx, pos] = v[:, 0].to(v_cache.dtype)
        lens = kv_len if kv_len is not None else pos + 1
        out = _mha(env, q, k_cache, v_cache, causal=False, kv_len=lens)
        new_cache = (k_cache, v_cache)
    out = out.reshape(B, Sq, H * hd)
    return _linear(out, p["wo"]), new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int,
                kw: Dict[str, Any]) -> Params:
    return {"wg": dense_init(gen, (d_ff, d_model), **kw),
            "wu": dense_init(gen, (d_ff, d_model), **kw),
            "wd": dense_init(gen, (d_model, d_ff), **kw)}


def swiglu(env: Env, p: Params, x: torch.Tensor) -> torch.Tensor:
    g = _linear(x, p["wg"])
    u = _linear(x, p["wu"])
    h = F.silu(g.float()).to(x.dtype) * u
    return _linear(h, p["wd"])


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int,
                  kw: Dict[str, Any]) -> Params:
    return {"w1": dense_init(gen, (d_ff, d_model), **kw),
            "b1": torch.zeros(d_ff, **kw),
            "w2": dense_init(gen, (d_model, d_ff), **kw),
            "b2": torch.zeros(d_model, **kw)}


def gelu_mlp(env: Env, p: Params, x: torch.Tensor) -> torch.Tensor:
    """fc1 -> GELU -> fc2 with biases (whisper); the GELU is the reference's
    ``jax.nn.gelu``, whose default is the tanh approximation."""
    h = _linear(x, p["w1"], p["b1"])
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return _linear(h, p["w2"], p["b2"])


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embed(env: Env, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens].to(env.compute_dtype)


def lm_head(env: Env, table_or_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits from a (V, D) matrix: the embedding table when embeddings are
    tied, else the head converted to (out, in) layout."""
    return _linear(x, table_or_w)
