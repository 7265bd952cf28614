"""The decode-attention op on the CPU: its plain version against the plain
attention it replaces, the split plan, ``_mha``'s gate, and greedy serving
through the op.  The CUDA kernel itself is held to the plain version on the
card (``tests/test_torch_decode_attention_cuda.py``).

* ``ref.reference_decode_attention`` equals ``layers._mha_dense(causal=
  False, kv_len=...)`` for one query bit for bit, in fp32 and in bf16, at
  every head width the port decodes with and at GQA groups of 1-16, with
  lengths of 1, of the whole cache and ragged;
* ``_mha`` sends one query over lengths, not causal, with no gradient, to
  the op, and everything else where it went before;
* minicpm-2b and nemotron-3-nano at a tiny width serve the same greedy
  tokens through the op as through the plain attention, and the
  ``attn.decode_kernel_calls`` counter counts each attention layer of each
  decode step.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import kernel, ops
from repro_torch.kernels.decode_attention.ref import \
    reference_decode_attention
from repro_torch.launch.train import scale_config
from repro_torch.models import Env, get_model, layers
from repro_torch.serve import ServeEngine

CPU = Env(torch.device("cpu"), torch.float32)
WIDTHS = (64, 96, 112, 128)
GROUPS = (1, 3, 5, 8, 16)
B, S_MAX, K = 3, 40, 2


def _lengths(pattern: str, b: int = B, s: int = S_MAX) -> torch.Tensor:
    if pattern == "one":
        return torch.ones(b, dtype=torch.long)
    if pattern == "full":
        return torch.full((b,), s, dtype=torch.long)
    return torch.tensor([1, s // 2 + 3, s - 1][:b], dtype=torch.long)


def _inputs(hd, G, dtype, b=B, s=S_MAX, k=K, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, 1, G * k, hd, generator=g).to(dtype)
    kc = torch.randn(b, s, k, hd, generator=g).to(dtype)
    vc = torch.randn(b, s, k, hd, generator=g).to(dtype)
    return q, kc, vc


@pytest.mark.parametrize("pattern", ("one", "full", "ragged"))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("fp32", "bf16"))
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("hd", WIDTHS)
def test_plain_version_is_mha_dense_for_one_query(hd, G, dtype, pattern):
    q, kc, vc = _inputs(hd, G, dtype)
    lens = _lengths(pattern)
    want = layers._mha_dense(CPU, q, kc, vc, causal=False, kv_len=lens)
    got = reference_decode_attention(q, kc, vc, lens)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, want)
    with torch.no_grad():
        assert torch.equal(ops.decode_attention(q, kc, vc, lens), want)
        assert torch.equal(layers._mha(CPU, q, kc, vc, causal=False,
                                       kv_len=lens), want)


@pytest.mark.parametrize("shape,expect", [
    # minicpm-2b's cells: 16 slots x 36 KV heads, G 1, over 4136 / 1544
    ((16, 36, 1, 4136), (1, 1, 8, 544)),
    ((16, 36, 1, 1544), (1, 1, 7, 224)),
    # nemotron-3-nano's: 64 slots x 2 KV heads, G 16, over 1544
    ((64, 2, 16, 1544), (16, 1, 7, 224)),
    # qwen2.5's G 5, one slot, a short cache; G 2 takes a block of 4 heads
    # (no block of 2 is built); and a group wider than 16
    ((1, 8, 5, 100), (8, 1, 1, 128)),
    ((4, 4, 2, 300), (4, 1, 2, 160)),
    ((2, 1, 24, 5000), (16, 2, 20, 256)),
])
def test_split_plan(shape, expect):
    Bs, Kh, G, S = shape
    gb, groups, nsplit, chunk = kernel.split_plan(Bs, Kh, G, S, sms=132)
    assert (gb, groups, nsplit, chunk) == expect
    assert gb & (gb - 1) == 0 and gb >= min(G, kernel.MAX_GROUP)
    assert gb * groups >= G and gb * (groups - 1) < G
    assert chunk % kernel.TILE == 0
    assert nsplit * chunk >= S and (nsplit - 1) * chunk < S


def test_the_kernel_refuses_cpu_tensors():
    q, kc, vc = _inputs(64, 1, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.decode_attention_fwd(q, kc, vc, _lengths("full"))


def _route(monkeypatch):
    """Records where ``_mha`` sends each call."""
    seen = []

    def tag(name, fn):
        def wrapped(*a, **kw):
            seen.append(name)
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(layers, "decode_attention",
                        tag("decode", layers.decode_attention))
    monkeypatch.setattr(layers, "_mha_dense", tag("dense", layers._mha_dense))
    monkeypatch.setattr(layers, "flash_attention",
                        tag("flash", layers.flash_attention))
    return seen


@pytest.mark.parametrize("case,where", [
    ("decode", ["decode"]),
    ("decode_with_grad_off_the_inputs", ["decode"]),
    ("causal_one_query", ["dense"]),
    ("no_lengths", ["dense"]),
    ("two_queries", ["dense"]),
    ("causal_prompt", ["flash"]),
    ("gradient_wanted", ["dense"]),
    ("meta", ["dense"]),
    ("query_chunks", ["dense", "dense"]),
])
def test_the_gate_routes_only_decode_to_the_op(monkeypatch, case, where):
    seen = _route(monkeypatch)
    q, kc, vc = _inputs(64, 2, torch.float32)
    lens, causal, env = _lengths("ragged"), False, CPU
    grad = False
    if case == "causal_one_query":
        causal = True
    elif case == "no_lengths":
        lens = None
    elif case == "two_queries":
        q = torch.cat([q, q], dim=1)
    elif case == "causal_prompt":
        q, kc, vc = _inputs(64, 2, torch.float32, s=8)
        q = q.expand(-1, 8, -1, -1).contiguous()
        lens, causal = None, True
    elif case == "gradient_wanted":
        q.requires_grad_()
        grad = True
    elif case == "decode_with_grad_off_the_inputs":
        grad = True
    elif case == "meta":
        q, kc, vc = (t.to("meta") for t in (q, kc, vc))
        lens = lens.to("meta")
    elif case == "query_chunks":
        q = torch.cat([q] * 4, dim=1)
        env = dataclasses.replace(CPU, attn_q_chunk=2)
    with torch.set_grad_enabled(grad):
        out = layers._mha(env, q, kc, vc, causal=causal, kv_len=lens)
    assert out.shape == q.shape
    assert seen == where


def _tiny(arch):
    return scale_config(get_config(arch), "10m")


def _serve(cfg, params, prompts, budgets):
    eng = ServeEngine(get_model(cfg), CPU, params, max_batch=2, max_len=40)
    for p, b in zip(prompts, budgets):
        eng.submit(p, max_new_tokens=b)
    done = sorted(eng.run(), key=lambda r: r.rid)
    return [list(r.output) for r in done], len(eng.timings["decode"])


@pytest.mark.parametrize("arch", ("minicpm-2b", "nemotron-3-nano-30b-a3b"))
def test_tiny_serving_through_the_op_keeps_its_tokens(monkeypatch, arch):
    cfg = _tiny(arch)
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu",
                      dtype=torch.float32)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 5, 12, 7)]
    budgets = [5, 3, 6, 4]
    attn_layers = cfg.layer_kinds.count("*")
    obs.reset_metrics()
    obs.enable_metrics(True)
    try:
        tokens, ticks = _serve(cfg, params, prompts, budgets)
        calls = obs.snapshot()["attn.decode_kernel_calls"]["value"]
    finally:
        obs.disable_metrics()
        obs.reset_metrics()
    assert calls == attn_layers * ticks > 0
    monkeypatch.setattr(layers, "_to_decode_op", lambda *a, **kw: False)
    before, _ = _serve(cfg, params, prompts, budgets)
    assert tokens == before
    assert [len(t) for t in tokens] == budgets
