"""Model building blocks: RMS and layer norms, RoPE, GQA attention, the
SwiGLU and GELU MLPs, embeddings.

Plain functions over parameter dicts with the reference's key names.
Projection weights are in ``nn.Linear``'s (out, in) layout and applied with
``F.linear``; causal attention over a prompt goes to the flash kernel
(:func:`repro_torch.kernels.flash_attention.ops.flash_attention`); decode,
one query against a cache up to each sequence's length, to the split-KV
decode kernel (:func:`repro_torch.kernels.decode_attention.ops.
decode_attention`), which reads the cache where it lies; non-causal
(encoder) attention and cross-attention stay plain tensor code, as the
reference runs them outside Pallas.

Under a mesh with a tp axis (``env.tp_shards``) each rank holds its shard
(``distributed/sharding.py``): attention keeps its block of query heads and
the KV heads they read, and the flash kernel runs on those local heads;
``wo`` is row-parallel, followed by one all-reduce.  The MLPs are
column-parallel up and row-parallel down, with one all-reduce (whisper's
``b2`` is added after it).  Where the vocab divides the width, the
embedding is a masked lookup plus an all-reduce and the head's sharded
logits are all-gathered for sampling (a training forward keeps them
sharded for the loss's vocab-parallel softmax); elsewhere both replicate.
Every collective goes through ``distributed/collectives.py``, in the
differentiable forms a training backward needs (:func:`tp_enter`,
:func:`tp_exit`: Megatron's f and g, or, with ``env.seq_shard_activations``,
an all-gather along the sequence into each sublayer and a reduce-scatter
out of it).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.collectives import (copy_to, gather,
                                       gather_from, reduce_from, scatter_sum,
                                       split_to)
from ..distributed.sharding import kv_heads, kv_map
from ..kernels.decode_attention.ops import decode_attention
from ..kernels.flash_attention.ops import flash_attention
from ..obs import metrics as _obs_metrics
from .common import Env, checkpointed, dense_init, leaf, zeros

Params = Dict[str, Any]
KV = Tuple[torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# Entering and leaving a tensor-parallel sublayer
# ---------------------------------------------------------------------------

def seq_parallel(env: Env) -> bool:
    """Whether the residual stream is split over tp along the sequence
    (the forward sets ``seq_shard_activations`` only where it applies)."""
    return env.seq_shard_activations and env.mesh is not None and \
        env.tp_axis is not None


def tp_enter(env: Env, x: torch.Tensor, sharded: bool) -> torch.Tensor:
    """A sublayer's input.  ``sharded``: the sublayer splits over tp (its
    ranks compute different parts of the input's gradient).  Under
    sequence parallelism the rank's block of the sequence is gathered
    whole first."""
    if seq_parallel(env):
        return (gather if sharded else gather_from)(x, env.tp_group, 1)
    return copy_to(x, env.tp_group) if sharded else x


def tp_exit(env: Env, y: torch.Tensor, sharded: bool) -> torch.Tensor:
    """A sublayer's output: the sum of a sharded sublayer's partial
    outputs over tp (under sequence parallelism, the rank's block of the
    sequence of that sum)."""
    if seq_parallel(env):
        return (scatter_sum if sharded else split_to)(y, env.tp_group, 1)
    return reduce_from(y, env.tp_group) if sharded else y


def replicated_weight(env: Env, w: torch.Tensor) -> torch.Tensor:
    """A weight kept whole on every tp rank but applied, under sequence
    parallelism, to each rank's own tokens: its gradient is summed over
    tp (a norm gain)."""
    return copy_to(w, env.tp_group) if seq_parallel(env) else w


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
    p: Params = {"wq": dense_init(gen, (H * hd, d_model), **leaf(kw, "wq")),
                 "wk": dense_init(gen, (K * hd, d_model), **leaf(kw, "wk")),
                 "wv": dense_init(gen, (K * hd, d_model), **leaf(kw, "wv")),
                 "wo": dense_init(gen, (d_model, H * hd), **leaf(kw, "wo"))}
    if qkv_bias:
        p["bq"] = zeros((H * hd,), **leaf(kw, "bq"))
        p["bk"] = zeros((K * hd,), **leaf(kw, "bk"))
        p["bv"] = zeros((K * hd,), **leaf(kw, "bv"))
    return p


def _mha(env: Env, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool, q_offset: Optional[torch.Tensor] = None,
         kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,Sq,H,hd), k/v: (B,Sk,K,hd) with H = G*K.

    ``q_offset``: (B,) absolute position of q[:,0].  ``kv_len``: (B,) valid
    KV length (continuous batching).  Causal attention over more than one
    query goes to the flash kernel, one query over a cache with its
    lengths (:func:`_to_decode_op`) to the decode kernel; the rest (the
    encoder, cross-attention, training) is plain tensor code, as is
    everything on meta tensors (a dry run, which launches no kernel, as the
    reference's dry run lowers no Pallas).  With
    ``env.attn_q_chunk`` the plain attention runs query chunk by query
    chunk, each checkpointed under grad (the reference's scan over chunks
    with ``jax.checkpoint``): the live score tensor shrinks by the chunk
    factor, and the result is exact.
    """
    if causal and q.shape[1] > 1 and q.device.type != "meta":
        return flash_attention(q, k, v, q_offset=q_offset)
    if _to_decode_op(q, k, v, causal=causal, kv_len=kv_len):
        if _obs_metrics.REGISTRY.enabled:
            _obs_metrics.counter("attn.decode_kernel_calls",
                                 "Decode attention calls sent to the split-KV "
                                 "op (its plain version off the card).",
                                 "calls").inc()
        return decode_attention(q, k, v, kv_len)
    cq = env.attn_q_chunk
    B, Sq = q.shape[:2]
    if cq and Sq > cq and Sq % cq == 0:
        base = (q_offset if q_offset is not None else
                torch.zeros((B,), dtype=torch.long, device=q.device))

        def chunk(qb, offset):
            return _mha_dense(env, qb, k, v, causal=causal, q_offset=offset,
                              kv_len=kv_len)
        outs = []
        for i in range(Sq // cq):
            qb = q[:, i * cq:(i + 1) * cq]
            if torch.is_grad_enabled():
                outs.append(checkpointed(env, chunk, qb, base + i * cq))
            else:
                outs.append(chunk(qb, base + i * cq))
        return torch.cat(outs, dim=1)
    return _mha_dense(env, q, k, v, causal=causal, q_offset=q_offset,
                      kv_len=kv_len)


def _to_decode_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, kv_len: Optional[torch.Tensor]) -> bool:
    """Whether :func:`_mha` sends a call to the decode op: one query over
    keys masked by their lengths, not causal, on real tensors (not meta),
    and no gradient wanted of q, k or v."""
    wanted = torch.is_grad_enabled() and any(t.requires_grad
                                             for t in (q, k, v))
    return (q.shape[1] == 1 and kv_len is not None and not causal
            and q.device.type != "meta" and not wanted)


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
    ``num_heads``/``num_kv_heads`` are the model's; under a tp mesh the
    block runs its rank's local heads (the caches hold its KV heads).
    """
    H, K, hd = num_heads, num_kv_heads, head_dim
    shard = env.tp_shards(H)
    x = tp_enter(env, x, shard)
    B, Sq, _ = x.shape
    kv_index = None
    if shard:
        _, K = kv_heads(H, K, env.tp, env.tp_rank, True)
        kv_index = kv_map(H, num_kv_heads, env.tp, env.tp_rank, True)
        H = H // env.tp
    q = _linear(x, p["wq"], p.get("bq")).reshape(B, Sq, H, hd)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)

    def attend(k, v, **kw):
        if kv_index is not None:     # KV heads shared unevenly by the block
            k = k.index_select(2, kv_index.to(k.device))
            v = v.index_select(2, kv_index.to(v.device))
        return _mha(env, q, k, v, **kw)

    def project(out):
        return tp_exit(env, _linear(out.reshape(B, Sq, H * hd), p["wo"]),
                       shard)

    if cross_kv is not None:
        k, v = cross_kv
        return project(attend(k, v, causal=False, kv_len=kv_len)), None

    k = _linear(x, p["wk"], p.get("bk")).reshape(B, Sq, K, hd)
    v = _linear(x, p["wv"], p.get("bv")).reshape(B, Sq, K, hd)
    if use_rope:
        k = apply_rope(k, positions, rope_theta)

    if kv_cache is None:
        out = attend(k, v, causal=causal,
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
        out = attend(k_cache, v_cache, causal=False, kv_len=lens)
        new_cache = (k_cache, v_cache)
    return project(out), new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int,
                kw: Dict[str, Any]) -> Params:
    return {"wg": dense_init(gen, (d_ff, d_model), **leaf(kw, "wg")),
            "wu": dense_init(gen, (d_ff, d_model), **leaf(kw, "wu")),
            "wd": dense_init(gen, (d_model, d_ff), **leaf(kw, "wd"))}


def _row_parallel(env: Env, d_ff: Optional[int]) -> bool:
    """Whether an MLP of hidden width ``d_ff`` is split over tp (its down
    projection then needs an all-reduce).  Under a mesh the caller must
    say the width: a rank's shard alone cannot tell."""
    if env.mesh is None:
        return False
    if d_ff is None:
        raise ValueError("under a mesh an MLP needs its full hidden width")
    return env.tp_shards(d_ff)


def swiglu(env: Env, p: Params, x: torch.Tensor,
           d_ff: Optional[int] = None) -> torch.Tensor:
    """``d_ff``: the full hidden width (needed under a mesh)."""
    split = _row_parallel(env, d_ff)
    x = tp_enter(env, x, split)
    g = _linear(x, p["wg"])
    u = _linear(x, p["wu"])
    h = F.silu(g.float()).to(x.dtype) * u
    return tp_exit(env, _linear(h, p["wd"]), split)


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int,
                  kw: Dict[str, Any]) -> Params:
    return {"w1": dense_init(gen, (d_ff, d_model), **leaf(kw, "w1")),
            "b1": zeros((d_ff,), **leaf(kw, "b1")),
            "w2": dense_init(gen, (d_model, d_ff), **leaf(kw, "w2")),
            "b2": zeros((d_model,), **leaf(kw, "b2"))}


def gelu_mlp(env: Env, p: Params, x: torch.Tensor,
             d_ff: Optional[int] = None) -> torch.Tensor:
    """fc1 -> GELU -> fc2 with biases (whisper); the GELU is the reference's
    ``jax.nn.gelu``, whose default is the tanh approximation.  ``d_ff``:
    the full hidden width (needed under a mesh)."""
    split = _row_parallel(env, d_ff)
    x = tp_enter(env, x, split)
    h = _linear(x, p["w1"], p["b1"])
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    if not split:
        return tp_exit(env, _linear(h, p["w2"], p["b2"]), False)
    out = tp_exit(env, _linear(h, p["w2"]), True)
    return out + p["b2"].to(out.dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embed(env: Env, table: torch.Tensor, tokens: torch.Tensor,
          vocab: Optional[int] = None) -> torch.Tensor:
    """Rows of ``table`` for ``tokens``.  ``vocab``: the full vocabulary;
    where it splits over tp, this rank's (V/tp, D) block looks up the tokens
    it holds, zeros the rest, and an all-reduce sums the ranks' rows."""
    if vocab is None or not env.tp_shards(vocab):
        return table[tokens].to(env.compute_dtype)
    rows = table.shape[0]
    local = tokens - env.tp_rank * rows
    inside = (local >= 0) & (local < rows)
    out = table[local.clamp(0, rows - 1)].to(env.compute_dtype)
    out = torch.where(inside[..., None], out, torch.zeros_like(out))
    return reduce_from(out, env.tp_group)


def vocab_parallel(env: Env, vocab: Optional[int]) -> bool:
    """Whether a training forward's logits stay split over tp by vocabulary
    (more than one tp rank, and the vocabulary divides them)."""
    return vocab is not None and env.tp > 1 and env.tp_shards(vocab)


def lm_head(env: Env, table_or_w: torch.Tensor, x: torch.Tensor,
            vocab: Optional[int] = None, *,
            gather_vocab: bool = True) -> torch.Tensor:
    """Logits from a (V, D) matrix: the embedding table when embeddings are
    tied, else the head converted to (out, in) layout.  Where ``vocab``
    splits over tp, each rank's (V/tp) logits are all-gathered, unless
    ``gather_vocab`` is off (a training forward: :func:`vocab_parallel`
    logits stay this rank's, for the loss's vocab-parallel softmax)."""
    sharded = vocab is not None and env.tp_shards(vocab)
    x = tp_enter(env, x, sharded)
    logits = _linear(x, table_or_w)
    if not sharded or not gather_vocab:
        return logits
    return gather_from(logits, env.tp_group, dim=-1)
