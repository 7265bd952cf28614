"""The port's dense decoder against the reference's, on the CPU.

A reduced minicpm-shaped config (2 layers, d_model 128, 4 heads, d_ff 256,
vocab 512, tied embeddings), in MHA and GQA form, in fp32.  Weights come
from the reference ``transformer.init`` through ``params_from_jax``; tokens
are made with numpy from a seed.  Logits and caches agree within 1e-4: the
two frameworks sum in different orders on the CPU, and the reference's
prefill attention is its dense einsum where the port's is the flash plain
version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jax_tf
from repro.models.common import Env as JaxEnv
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import Env, get_model, params_from_jax
from repro_torch.models import moe, transformer

TOL = 1e-4
CPU = torch.device("cpu")


def _cfgs(kv_heads):
    small = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=kv_heads,
                 head_dim=32,
                 d_ff=256, vocab_size=512, name=f"minicpm-tiny-kv{kv_heads}")
    return (dataclasses.replace(jax_get_config("minicpm-2b"), **small),
            dataclasses.replace(get_config("minicpm-2b"), **small))


@pytest.fixture(scope="module", params=[4, 2], ids=["mha", "gqa"])
def pair(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = jax_tf.init(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    tparams = params_from_jax(np_params, tcfg, device=CPU, dtype=torch.float32)
    return jcfg, tcfg, jparams, tparams


JENV = JaxEnv(compute_dtype=jnp.float32)
TENV = Env(CPU, torch.float32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=TOL, atol=TOL)


def test_config_copy_matches_reference():
    for arch in ("minicpm-2b", "mamba2-370m", "zamba2-1.2b"):
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            jax_get_config(arch))


def test_prefill_logits_and_cache(pair):
    jcfg, tcfg, jparams, tparams = pair
    tokens = np.random.default_rng(0).integers(0, 512, (2, 16)).astype(np.int32)
    jl, jc = jax_tf.prefill(JENV, jcfg, jparams,
                            {"tokens": jnp.asarray(tokens)}, max_len=24)
    tl, tc = transformer.prefill(TENV, tcfg, tparams,
                                 {"tokens": torch.from_numpy(tokens).long()},
                                 max_len=24)
    assert tl.shape == (2, 1, 512)
    _close(tl, jl)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape
        _close(tc[name], jc[name])


def test_decode_steps_with_ragged_pos(pair):
    jcfg, tcfg, jparams, tparams = pair
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 512, (2, 12)).astype(np.int32)
    _, jc = jax_tf.prefill(JENV, jcfg, jparams,
                           {"tokens": jnp.asarray(tokens)}, max_len=20)
    _, tc = transformer.prefill(TENV, tcfg, tparams,
                                {"tokens": torch.from_numpy(tokens).long()},
                                max_len=20)
    pos = np.array([12, 7], np.int32)           # second sequence rewinds
    for _ in range(4):
        step = rng.integers(0, 512, (2, 1)).astype(np.int32)
        jl, jc = jax_tf.decode_step(JENV, jcfg, jparams, jc,
                                    {"tokens": jnp.asarray(step),
                                     "pos": jnp.asarray(pos)})
        tl, tc = transformer.decode_step(
            TENV, tcfg, tparams, tc, {"tokens": torch.from_numpy(step).long(),
                                      "pos": torch.from_numpy(pos).long()})
        assert tl.shape == (2, 1, 512)
        _close(tl, jl)
        pos = pos + 1
    for name in ("k", "v"):
        _close(tc[name], jc[name])


def test_init_follows_reference_distributions():
    _, tcfg = _cfgs(2)
    gen = torch.Generator().manual_seed(0)
    p = get_model(tcfg).init(gen, device="cpu")
    wq = p["blocks"][0]["attn"]["wq"]
    assert tuple(wq.shape) == (4 * tcfg.head_dim, 128)      # (out, in)
    assert float(wq.abs().max()) <= 2.0 * 128 ** -0.5
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
    assert float(p["blocks"][1]["ln2"].abs().sum()) == 0.0


def test_moe_ffn_names_its_roadmap_item_for_expert_parallelism():
    cfg = ModelConfig(name="x-moe", family="moe", num_layers=1, d_model=16,
                      num_heads=2, num_kv_heads=2, d_ff=8, vocab_size=32,
                      num_experts=4, experts_per_token=2)
    p = transformer.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.zeros((1, 2, 16))
    # expert parallelism (Queue 1, item 9) landed: its width is the env's
    # tp, and the keyword that named it is gone
    with pytest.raises(TypeError, match="tp"):
        moe.moe_ffn(TENV, p["blocks"][0]["moe"], x, num_experts=4,
                    experts_per_token=2, tp=2)
    assert TENV.tp == 1
    y, aux = moe.moe_ffn(TENV, p["blocks"][0]["moe"], x, num_experts=4,
                         experts_per_token=2)
    assert tuple(y.shape) == (1, 2, 16) and aux.ndim == 0


#: the six decoder families, one reduced config each
DECODERS = ("minicpm-2b", "moonshot-v1-16b-a3b", "phi-3-vision-4.2b",
            "mamba2-370m", "zamba2-1.2b", "nemotron-3-nano-30b-a3b")


def _block_spans(cfg, rows):
    """The ``block.*`` spans of one pass over ``cfg``'s layers, in order,
    each as (name, depth, attributes); ``rows``: the tokens of the pass
    times the experts a token."""
    names = {"M": "block.ssm", "E": "block.moe",
             "*": "block.attn" if cfg.family == "hybrid_moe"
             else "block.attn_ffn"}
    out = []
    for i, kind in enumerate(cfg.layer_kinds):
        out.append((names[kind], 0, {"rows": rows} if kind == "E" else {}))
        if cfg.attn_period and (i + 1) % cfg.attn_period == 0:
            out.append(("block.shared", 0, {}))
    return out


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_decode_spans(arch):
    """The spans ``perfbench/program_trace.py`` reads: the cache's in the
    prefill only, one a layer (and one a shared-block application) in
    layer order with the MoE's rows, the logits' last."""
    from repro_torch import obs
    cfg = get_config(arch).reduced()
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    B, S, k = 2, 5, cfg.experts_per_token
    tracer = obs.Tracer(enabled=True)
    saved = obs.set_tracer(tracer)
    try:
        _, cache = api.prefill(TENV, params, {
            "tokens": torch.arange(B * S).reshape(B, S)}, max_len=8)
        prefill = [(r.name, r.depth, r.attr_dict()) for r in tracer.spans]
        tracer.clear()
        api.decode_step(TENV, params, cache, {
            "tokens": torch.ones(B, 1, dtype=torch.long),
            "pos": torch.tensor([S, S - 2])})
        decode = [(r.name, r.depth, r.attr_dict()) for r in tracer.spans]
    finally:
        obs.set_tracer(saved)
    logits = [("model.logits", 0, {})]
    assert prefill == ([("model.cache_init", 0, {})]
                       + _block_spans(cfg, B * S * k) + logits)
    assert decode == _block_spans(cfg, B * k) + logits
    if arch == "zamba2-1.2b":
        assert [n for n, _, _ in prefill].count("block.shared") == 2
