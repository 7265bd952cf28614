"""The port's Mamba2 block and the ssm/hybrid decoders against the
reference's, on the CPU.

Reduced configs (``ModelConfig.reduced()``): mamba2 with 2 layers, zamba2
with 4 layers and its shared attention block every 2; d_model 64, SSM
state 16, head dim 16, chunk 16, vocab 256, in fp32.  Weights come from the
reference ``init`` through ``params_from_jax``; tokens and activations are
made with numpy from a seed.  Logits and every cache entry agree within
1e-4: the two frameworks sum in different orders on the CPU.  Prompts of
40 tokens leave the last SSD chunk ragged (40 = 2 x 16 + 8).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_tf
from repro.models.common import Env as JaxEnv
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import Env, get_model, params_from_jax
from repro_torch.models import ssm, transformer
from repro_torch.serve import ServeEngine

TOL = 1e-4
CPU = torch.device("cpu")
JENV = JaxEnv(compute_dtype=jnp.float32)
TENV = Env(CPU, torch.float32)
ARCHS = ["mamba2-370m", "zamba2-1.2b"]


def _cfgs(arch):
    return jax_get_config(arch).reduced(), get_config(arch).reduced()


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = jax_tf.init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device=CPU, dtype=torch.float32)
    return jcfg, tcfg, jparams, tparams


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _cache_close(tc, jc):
    assert sorted(tc) == sorted(jc)
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape, name
        _close(tc[name], jc[name])


def _ssm_block_params(jcfg, seed):
    jp = jax_ssm.init_ssm(jax.random.PRNGKey(seed), jcfg.d_model,
                          expand=jcfg.ssm_expand, head_dim=jcfg.ssm_head_dim,
                          n_state=jcfg.ssm_state,
                          conv_width=jcfg.ssm_conv_width)
    # non-zero norm gain and conv bias, so both are exercised
    rng = np.random.default_rng(seed)
    jp["norm"] = jnp.asarray(rng.normal(size=jp["norm"].shape) * 0.1,
                             jnp.float32)
    jp["conv_b"] = jnp.asarray(rng.normal(size=jp["conv_b"].shape) * 0.1,
                               jnp.float32)
    tp = {name: torch.from_numpy(np.array(a, np.float32))
          for name, a in jp.items()}
    for name in ("in_proj", "out_proj"):
        tp[name] = tp[name].T.contiguous()
    return jp, tp


@pytest.mark.parametrize("S", [40, 16, 5])
def test_ssm_block_prefill_matches_reference(S):
    jcfg, tcfg = _cfgs("mamba2-370m")
    jp, tp = _ssm_block_params(jcfg, 0)
    x = np.random.default_rng(1).normal(size=(2, S, 64)).astype(np.float32)
    jy, (jst, jconv) = jax_ssm.ssm_block(JENV, jp, jnp.asarray(x), jcfg)
    ty, (tst, tconv) = ssm.ssm_block(TENV, tp, torch.from_numpy(x), tcfg)
    _close(ty, jy)
    _close(tst, jst)
    _close(tconv, jconv)


@pytest.mark.parametrize("S", [1, 7])
def test_ssm_block_with_cache_matches_reference(S):
    """One token takes the recurrent update, several the SSD scan from the
    cached state; both continue a 20-token prefill."""
    jcfg, tcfg = _cfgs("mamba2-370m")
    jp, tp = _ssm_block_params(jcfg, 2)
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=(2, 20, 64)).astype(np.float32)
    x1 = rng.normal(size=(2, S, 64)).astype(np.float32)
    _, jcache = jax_ssm.ssm_block(JENV, jp, jnp.asarray(x0), jcfg)
    _, tcache = ssm.ssm_block(TENV, tp, torch.from_numpy(x0), tcfg)
    jy, (jst, jconv) = jax_ssm.ssm_block(JENV, jp, jnp.asarray(x1), jcfg,
                                         cache=jcache)
    ty, (tst, tconv) = ssm.ssm_block(TENV, tp, torch.from_numpy(x1), tcfg,
                                     cache=tcache)
    _close(ty, jy)
    _close(tst, jst)
    _close(tconv, jconv)


def test_prefill_logits_and_cache(pair):
    jcfg, tcfg, jparams, tparams = pair
    tokens = np.random.default_rng(0).integers(0, 256, (2, 40)).astype(np.int32)
    jl, jc = jax_tf.prefill(JENV, jcfg, jparams,
                            {"tokens": jnp.asarray(tokens)}, max_len=48)
    tl, tc = transformer.prefill(TENV, tcfg, tparams,
                                 {"tokens": torch.from_numpy(tokens).long()},
                                 max_len=48)
    assert tl.shape == (2, 1, 256)
    _close(tl, jl)
    _cache_close(tc, jc)
    assert tc["state"].dtype == torch.float32


def test_decode_steps_with_ragged_pos(pair):
    jcfg, tcfg, jparams, tparams = pair
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 256, (2, 24)).astype(np.int32)
    _, jc = jax_tf.prefill(JENV, jcfg, jparams,
                           {"tokens": jnp.asarray(tokens)}, max_len=32)
    _, tc = transformer.prefill(TENV, tcfg, tparams,
                                {"tokens": torch.from_numpy(tokens).long()},
                                max_len=32)
    pos = np.array([24, 17], np.int32)           # second sequence rewinds
    for _ in range(3):
        step = rng.integers(0, 256, (2, 1)).astype(np.int32)
        jl, jc = jax_tf.decode_step(JENV, jcfg, jparams, jc,
                                    {"tokens": jnp.asarray(step),
                                     "pos": jnp.asarray(pos)})
        tl, tc = transformer.decode_step(
            TENV, tcfg, tparams, tc, {"tokens": torch.from_numpy(step).long(),
                                      "pos": torch.from_numpy(pos).long()})
        assert tl.shape == (2, 1, 256)
        _close(tl, jl)
        _cache_close(tc, jc)
        pos = pos + 1


BUDGETS = [3, 6, 2, 5, 4]


def _serve(engine, prompts):
    for prompt, budget in zip(prompts, BUDGETS):
        engine.submit(prompt, max_new_tokens=budget)
    return {r.rid: list(r.output) for r in engine.run()}


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    japi = jax_get_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device=CPU, dtype=torch.float32)
    prompts = list(np.random.default_rng(5).integers(0, 256, (5, 20)))
    # the reference engine always allocates a bf16 cache: hand it fp32
    japi = dataclasses.replace(
        japi, init_cache=lambda batch, max_len, env, dtype=None:
        jax_tf.init_cache(jcfg, batch, max_len, env, jnp.float32))
    ref = _serve(JaxServeEngine(japi, JENV, jparams, max_batch=2,
                                max_len=32), prompts)
    out = _serve(ServeEngine(get_model(tcfg), TENV, tparams, max_batch=2,
                             max_len=32), prompts)
    assert [len(out[i]) for i in range(5)] == BUDGETS
    assert out == ref


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_cache_keeps_fp32_state_and_fills_its_slot(arch):
    """Admission prefills into slot 0 of a 3-slot cache: every entry of the
    prefill's cache lands on axis 1 at that slot, in place, and the other
    slots stay empty."""
    _, tcfg = _cfgs(arch)
    api = get_model(tcfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu",
                      dtype=torch.bfloat16)
    env = Env(CPU, torch.bfloat16)
    eng = ServeEngine(api, env, params, max_batch=3, max_len=16)
    names = ["conv", "state"] + (["shared_k", "shared_v"]
                                 if tcfg.family == "hybrid" else [])
    assert sorted(eng.cache) == sorted(names)
    assert eng.cache["state"].dtype == torch.float32
    assert eng.cache["conv"].dtype == torch.bfloat16
    before = dict(eng.cache)
    prompt = np.arange(6)
    eng.submit(prompt, max_new_tokens=2)
    eng._admit()
    _, cache1 = api.prefill(env, params, {"tokens": torch.as_tensor(
        prompt[None], dtype=torch.long)}, max_len=16)
    for name, t in eng.cache.items():
        assert t is before[name], name               # updated in place
        assert torch.equal(t[:, 0], cache1[name][:, 0]), name
        assert float(t[:, 0].float().abs().sum()) > 0, name
        assert float(t[:, 1:].float().abs().sum()) == 0, name


@pytest.mark.parametrize("arch", ARCHS)
def test_init_follows_reference_layout(arch):
    _, tcfg = _cfgs(arch)
    p = get_model(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
    dims = ssm.ssm_dims(64, 2, 16, 16, 4)
    blk = p["blocks"][0]["ssm"]
    H = dims["nheads"]
    assert tuple(blk["in_proj"].shape) == (2 * 128 + 2 * 16 + H, 64)
    assert tuple(blk["out_proj"].shape) == (64, 128)        # (out, in)
    assert tuple(blk["conv_w"].shape) == (4, dims["d_conv"])
    assert float(blk["conv_w"].abs().max()) <= 2.0 * 4 ** -0.5
    torch.testing.assert_close(-torch.exp(blk["A_log"]),
                               -torch.linspace(1.0, 16.0, H))
    dt = torch.nn.functional.softplus(blk["dt_bias"])
    assert bool(((dt >= 1e-3 - 1e-7) & (dt <= 0.1 + 1e-7)).all())
    assert ("shared" in p) == (tcfg.family == "hybrid")


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_end_to_end_on_cpu(arch, capsys):
    res = serve_cli.main(["--arch", arch, "--device", "cpu", "--scale", "10m",
                          "--requests", "2", "--prompt-len", "12",
                          "--max-new", "3", "--max-batch", "2"])
    text = capsys.readouterr().out
    assert "ServingPlan:" in text and "tok/s" in text
    assert res["requests"] == 2 and res["tokens"] == 6
    assert res["device"] == "cpu"
