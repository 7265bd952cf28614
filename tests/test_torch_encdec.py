"""The port's whisper encoder-decoder against the reference's, on the CPU.

The reduced whisper-large-v3 (``cfg.reduced()``: 2 encoder and 2 decoder
layers, d_model 64, 4 heads of 16, 16 frames), fp32: the encoder's output,
the cross-attention K/V, prefill logits and all four cache entries, decode
steps at ragged positions and past the 4096-row position table (which
clips), and the engine's greedy tokens with zero stand-in frames, within
1e-4 (tokens equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jax_encdec
from repro_torch.models import encdec

from _torch_parity import JENV, TENV, close, check_prefill_and_decode, \
    make_pair, serve_both

ARCH = "whisper-large-v3"


@pytest.fixture(scope="module")
def pair():
    return make_pair(ARCH)


def _frames(cfg, B=2, seed=3):
    return np.random.default_rng(seed).normal(
        size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def test_encode_and_cross_kv(pair):
    frames = _frames(pair.tcfg)
    jout = jax_encdec.encode(JENV, pair.jcfg, pair.jparams,
                             jnp.asarray(frames))
    tout = encdec.encode(TENV, pair.tcfg, pair.tparams,
                         torch.from_numpy(frames))
    close(tout, jout)
    jk, jv = jax_encdec._cross_kv(JENV, pair.jcfg, pair.jparams["dec_blocks"],
                                  jout)
    tk, tv = encdec._cross_kv(TENV, pair.tcfg, pair.tparams["dec_blocks"],
                              tout)
    assert tuple(tk.shape) == jk.shape == (pair.tcfg.num_layers, 2,
                                           pair.tcfg.encoder_seq,
                                           pair.tcfg.num_kv_heads,
                                           pair.tcfg.head_dim)
    close(tk, jk)
    close(tv, jv)


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_and_three_ragged_decode_steps(pair, seed):
    check_prefill_and_decode(pair, seed=seed, steps=3)


def test_positions_past_the_table_clip(pair):
    """Decode at positions 4097 and 5000 reads the table's last row, as the
    reference clips; the KV cache is long enough to hold them."""
    cfg = pair.tcfg
    assert pair.tparams["pos_embed"].shape[0] == encdec.POS_ROWS == 4096
    pos = torch.tensor([0, 4095, 4096, 9000])
    close(encdec._positions_embed(pair.tparams, pos),
          jax_encdec._positions_embed(pair.jparams, jnp.asarray(pos.numpy()),
                                      cfg.d_model))
    close(encdec._positions_embed(pair.tparams, pos)[3],
          pair.tparams["pos_embed"][-1])
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    frames = _frames(cfg)
    max_len = 5008
    _, jc = jax_encdec.prefill(JENV, pair.jcfg, pair.jparams,
                               {"tokens": jnp.asarray(tokens),
                                "frames": jnp.asarray(frames)}, max_len)
    _, tc = encdec.prefill(TENV, cfg, pair.tparams,
                           {"tokens": torch.from_numpy(tokens).long(),
                            "frames": torch.from_numpy(frames)}, max_len)
    pos = np.array([4097, 5000], np.int32)
    step = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    jl, _ = jax_encdec.decode_step(JENV, pair.jcfg, pair.jparams, jc,
                                   {"tokens": jnp.asarray(step),
                                    "pos": jnp.asarray(pos)})
    tl, _ = encdec.decode_step(TENV, cfg, pair.tparams, tc,
                               {"tokens": torch.from_numpy(step).long(),
                                "pos": torch.from_numpy(pos).long()})
    close(tl, jl)


def test_engine_greedy_tokens_equal_reference(pair):
    ref, port = serve_both(pair)
    assert port == ref


def test_init_cache_and_params_shapes(pair):
    cfg = pair.tcfg
    p = encdec.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert len(p["enc_blocks"]) == cfg.encoder_layers
    assert len(p["dec_blocks"]) == cfg.num_layers
    assert tuple(p["pos_embed"].shape) == (encdec.POS_ROWS, cfg.d_model)
    assert float(p["enc_norm"]["scale"].min()) == 1.0
    assert sorted(p["dec_blocks"][0]) == sorted(pair.tparams["dec_blocks"][0])
    cache = encdec.init_cache(cfg, 3, 10, TENV, dtype=torch.float32)
    assert tuple(cache["cross_k"].shape) == (cfg.num_layers, 3,
                                             cfg.encoder_seq,
                                             cfg.num_kv_heads, cfg.head_dim)
    assert tuple(cache["k"].shape) == (cfg.num_layers, 3, 10,
                                       cfg.num_kv_heads, cfg.head_dim)
